"""The port's bulk sweep tool (``biom3_tpu_torch/tools/run_sweep.py``, CPU).

Its copies of the JAX tool's numpy pieces, ``make_prompts`` (with its
templates) and ``qc_table``, equal ``tools/run_sweep.py``'s, on the same
ids; and ``--tiny --device cpu`` runs end to end once: phases, rates, the
QC table and the inpaint-recovery probe present and in range (the JAX
tool's ``test_run_sweep_tool_smoke``).
"""

import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from biom3_tpu.tokenizers.stage3_vocab import Stage3Vocab as JaxStage3Vocab
from biom3_tpu_torch.tokenizers import Stage3Vocab
from biom3_tpu_torch.tools import run_sweep

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import run_sweep as jax_run_sweep  # noqa: E402


def test_copies_equal_the_jax_tool():
    assert run_sweep._SUBJECTS == jax_run_sweep._SUBJECTS
    assert run_sweep._QUALIFIERS == jax_run_sweep._QUALIFIERS
    for name in ("make_prompts", "qc_table"):
        assert inspect.getsource(getattr(run_sweep, name)) == \
            inspect.getsource(getattr(jax_run_sweep, name)), name
    assert run_sweep.make_prompts(123) == jax_run_sweep.make_prompts(123)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 29, (12, 64)).astype(np.int32)
    ids[:6, 0], ids[:6, 50:] = 1, 2          # rows with a START and an END tail
    ids[6:8] = 5                             # two identical rows
    assert run_sweep.qc_table(ids, Stage3Vocab()) == jax_run_sweep.qc_table(ids,
                                                                           JaxStage3Vocab())


def test_run_sweep_tiny_on_the_cpu(tmp_path):
    out_path = tmp_path / "sweep.json"
    r = subprocess.run(
        [sys.executable, "-m", "biom3_tpu_torch.tools.run_sweep", "--tiny", "--device", "cpu",
         "--prompts", "4", "--replicas", "2", "--batch", "4", "--qc-inpaint-rows", "4",
         "--out", str(out_path)],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(out_path.read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == rep
    assert rep["metric"] == "sweep_prompts_per_hour"
    assert rep["value"] > 0
    assert rep["rates"]["total_sequences"] == 8
    assert rep["config"]["device"] == "cpu" and rep["config"]["stack_path"] is False
    qc = rep["qc"]
    assert qc["n"] == 8
    assert 0 <= qc["marker_valid_frac"] <= 1
    assert qc["class_entropy_nats"] > 0
    probe = rep["inpaint_recovery"]
    assert 0 <= probe["masked_blosum_soft_acc"] <= 1
    assert 0 < probe["masked_frac"] < 1
