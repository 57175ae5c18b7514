"""The port's parity harness (``biom3_tpu_torch/tools/parity_check.py``) on
tiny seeded checkpoints in the published layouts (CPU).

The checkpoints are ``tests/test_parity_harness.py``'s (a two-layer ESM2 and
BERT from ``transformers``, a weight-normed Facilitator) and its tiny
Stage-3 golden model.  ``python -m biom3_tpu_torch.tools.parity_check
--device cpu`` must print every gate's verdict line and FAIL overall with
exit code 1 (seeded weights cannot match the README), gate 3 (the port's
engine against the torch golden oracle on the same checkpoint) must PASS,
and the values gates 1–2 print must equal the JAX engines' on the same
files within 1e-4.  Without weights the tool exits 2.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_parity_harness import _build_tiny_parity_ckpts, _build_tiny_stage3_ckpt

REPO = pathlib.Path(__file__).resolve().parents[1]
GATES = ("z_p norms", "z_t norms", "dot diag", "homology[0,3]", "homology[1,4]", "norm_z_t",
         "norm_z_p", "norm_z_c", "mse_zc_zp", "mse_zt_zp", "mmd_zc_zp", "mmd_zp_zt")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _got(out: str) -> dict:
    """gate → the values its verdict line printed after 'got'."""
    vals = {}
    for gate in GATES:
        m = re.search(r"\] " + re.escape(gate) + r": got \[?([^\]w]*)\]? want", out)
        assert m, (gate, out)
        vals[gate] = np.array(m.group(1).split(), np.float64)
    return vals


def _jax_values(tmp_path) -> dict:
    """The JAX engines' gate values on the same files (f32, HIGHEST)."""
    from biom3_tpu.cli.demo_data import DEMO_CAPTIONS, DEMO_SEQUENCES
    from biom3_tpu.config import load_json_config
    from biom3_tpu.pipeline.stage1 import PenCLEngine, compute_scores
    from biom3_tpu.pipeline.stage2 import FacilitatorEngine

    engine = PenCLEngine(load_json_config(str(tmp_path / "s1.json")), str(tmp_path / "pencl.bin"))
    z_t, z_p = engine.embed(DEMO_CAPTIONS, DEMO_SEQUENCES)
    s = {k: np.asarray(v) for k, v in compute_scores(z_p, z_t).items()}
    _, m = FacilitatorEngine(load_json_config(str(tmp_path / "s2.json")),
                             str(tmp_path / "fac.bin")).run_dataset({"z_t": z_t, "z_p": z_p})
    return {"z_p norms": s["z_p_magnitude"], "z_t norms": s["z_t_magnitude"],
            "dot diag": np.diag(s["dot_product_scores"]),
            "homology[0,3]": s["homology_matrix"][0, 3],
            "homology[1,4]": s["homology_matrix"][1, 4],
            **{k: m[k] for k in GATES[5:]}}


def test_parity_check_runs_every_gate_and_fails_seeded_weights(tmp_path, monkeypatch):
    # the checkpoints come from transformers' torch models: skip its
    # TensorFlow import where transformers is not loaded yet
    monkeypatch.setenv("USE_TF", "0")
    _build_tiny_parity_ckpts(tmp_path)
    _build_tiny_stage3_ckpt(tmp_path)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    r = subprocess.run(
        [sys.executable, "-m", "biom3_tpu_torch.tools.parity_check", "--device", "cpu",
         "--pencl", str(tmp_path / "pencl.bin"), "--facilitator", str(tmp_path / "fac.bin"),
         "--proteoscribe", str(tmp_path / "s3.bin"),
         "--stage1_json", str(tmp_path / "s1.json"), "--stage2_json", str(tmp_path / "s2.json"),
         "--stage3_json", str(tmp_path / "s3.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    out = r.stdout
    assert r.returncode == 1, (r.returncode, out, r.stderr[-2000:])
    for gate in GATES:
        assert f"] {gate}:" in out, (gate, out)
    assert "[PASS] stage3 temp-0 sequences vs in-process torch golden oracle: 0/128" in out, out
    assert "OVERALL: FAIL" in out and "nan" not in out.lower(), out
    got, want = _got(out), _jax_values(tmp_path)
    for gate in GATES:
        np.testing.assert_allclose(got[gate], np.round(np.asarray(want[gate], np.float64), 6),
                                   atol=1e-4, rtol=0, err_msg=gate)


def test_parity_check_refuses_without_weights(capsys):
    from biom3_tpu_torch.tools import parity_check

    assert parity_check.main(["--device", "cpu"]) == 2
    assert "no weights given" in capsys.readouterr().out
