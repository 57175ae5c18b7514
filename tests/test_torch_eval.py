"""The QC end of the sweep in biom3_tpu_torch against the JAX package (CPU).

``training/metrics.py``: ``blosum_soft_accuracy`` (its BLOSUM62 table and
decode-id lookup copies equal to the JAX package's), ``singular_spectrum``
with and without the reference's normalisation quirk and ``rankme``,
against the JAX functions on the same seeded inputs (f32: rtol 1e-5, the
SVD within rtol 1e-4 of its largest value); ``cli/run_eval.py --device
cpu``: the printed JSON report and the saved report equal the JAX CLI's on the same
designs and references (a replica dict with out-of-vocab designs, and the
e2e layout): the same keys, counts and strings, and every float within
rtol 1e-6 (the f32 batch means sum in another order: the last bit moves);
its default ``--device cuda`` stops without a card.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.training import metrics as jax_metrics
from biom3_tpu_torch.training import metrics

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_blosum_tables_equal_the_jax_package():
    assert metrics.BLOSUM62_ALPHABET == jax_metrics.BLOSUM62_ALPHABET
    for name in ("BLOSUM62", "BLOSUM62_SOFT", "DECODE_TO_BLOSUM"):
        got, want = getattr(metrics, name), getattr(jax_metrics, name)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name


def test_blosum_soft_accuracy_equals_jax():
    rng = np.random.default_rng(0)
    C = len(metrics.DECODE_TO_BLOSUM)
    pred = rng.integers(0, C, (6, 40)).astype(np.int32)
    real = np.where(rng.random((6, 40)) < 0.4, pred, rng.integers(0, C, (6, 40))).astype(np.int32)
    real[0] = pred[0]                     # a row of exact matches
    pred[1], real[1] = 0, 0               # a row with no amino acid: hard part alone
    got = metrics.blosum_soft_accuracy(torch.from_numpy(pred), torch.from_numpy(real))
    want = jax_metrics.blosum_soft_accuracy(jnp.asarray(pred), jnp.asarray(real))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("quirk", [False, True])
def test_singular_spectrum_and_rankme_equal_jax(quirk):
    z = np.random.default_rng(1).standard_normal((24, 12)).astype(np.float32)
    z[:, 3] *= 5.0
    got = metrics.singular_spectrum(torch.from_numpy(z), quirk_q9=quirk).numpy()
    want = np.asarray(jax_metrics.singular_spectrum(jnp.asarray(z), quirk_q9=quirk))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.max()))
    np.testing.assert_allclose(float(metrics.rankme(torch.from_numpy(want.copy()))),
                               float(jax_metrics.rankme(jnp.asarray(want))), rtol=1e-5)


def _same(got, want) -> bool:
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            _same(got[k], want[k]) for k in want)
    if isinstance(want, float):
        return isinstance(got, float) and abs(got - want) <= 1e-6 * abs(want)
    return got == want


def _run(module: str, *args: str) -> dict:
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env={"JAX_PLATFORMS": "cpu", **_env()})
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout)


def _env() -> dict:
    import os

    return {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}


def test_run_eval_report_equals_jax_cli(tmp_path):
    from biom3_tpu_torch.io.torch_io import load_torch_file, save_torch_file

    rng = np.random.default_rng(2)
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    refs = ["".join(rng.choice(aa, rng.integers(20, 60))) for _ in range(4)]
    mutate = lambda s: "".join(c if rng.random() < 0.6 else rng.choice(aa) for c in s)
    designs = {f"replica_{i}": [mutate(r) for r in refs] for i in range(2)}
    designs["replica_1"][2] = "MKJ" + designs["replica_1"][2]      # 'J': out of vocab
    designs["replica_1"].append("MK")                               # past the references
    save_torch_file(designs, tmp_path / "designs.pt")
    save_torch_file({"sequences": {"prompt_0": designs["replica_0"][:3]}}, tmp_path / "e2e.pt")
    save_torch_file({"sequence": refs}, tmp_path / "refs.pt")
    reports = {}
    for name in ("designs.pt", "e2e.pt"):
        args = ["--designs_path", str(tmp_path / name), "--reference_path",
                str(tmp_path / "refs.pt")]
        got = _run("biom3_tpu_torch.cli.run_eval", *args, "--output_path",
                   str(tmp_path / "port.pt"), "--device", "cpu")
        want = _run("biom3_tpu.cli.run_eval", *args, "--output_path", str(tmp_path / "jax.pt"))
        assert _same(got, want), (name, got, want)
        assert _same(load_torch_file(tmp_path / "port.pt"), load_torch_file(tmp_path / "jax.pt"))
        reports[name] = got
    assert reports["designs.pt"]["vs_reference"]["replica_1"]["skipped_out_of_vocab"] == 1
    assert reports["e2e.pt"]["vs_reference"]["prompt_0"]["blosum_soft_acc"] > 0


def test_run_eval_needs_a_card_unless_told_cpu(tmp_path):
    """``--device`` defaults to cuda: without a card the CLI stops, and
    nothing falls back to the CPU by itself."""
    from biom3_tpu_torch.cli import run_eval
    from biom3_tpu_torch.io.torch_io import save_torch_file

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    save_torch_file({"replica_0": ["MKV"]}, tmp_path / "designs.pt")
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_eval.main(["--designs_path", str(tmp_path / "designs.pt")])
