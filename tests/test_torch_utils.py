"""The port's utils against the JAX package's (CPU).

``utils/flops.py``: every formula equal to JAX's on the same configs (the
port's configs through ``port_config``); the peaks of the card by name.
``utils/profiling.py``: ``host_memory_mb`` as ``tests/test_io_utils.py``
holds it, no card → no device memory, a Chrome trace from
``profile_trace``.  ``utils/figures.py`` and
``utils/animation.py``: the spectrum report, the PNG, the decoded
trajectory and the GIF equal to JAX's.  ``data/mnist_data.py``: the file
is the JAX package's (no local MNIST, so nothing runs it).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from biom3_tpu.config import BertConfig, ESM2Config, PenCLConfig, ProteoScribeConfig
from biom3_tpu.utils import animation as jax_animation
from biom3_tpu.utils import figures as jax_figures
from biom3_tpu.utils import flops as jax_flops
from biom3_tpu_torch.io.from_jax import port_config
from biom3_tpu_torch.utils import animation, figures, flops, profiling

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIBES = [ProteoScribeConfig(),
           ProteoScribeConfig(num_classes=29, dim=64, depth=2, n_blocks=2, heads=4,
                              local_heads=1, local_window=16, max_seq_len=64, cond_dim=16)]
PENCLS = [PenCLConfig(),
          PenCLConfig(esm=ESM2Config(num_layers=2, embed_dim=64, attention_heads=4),
                      bert=BertConfig(num_layers=2, hidden_size=32, num_heads=2,
                                      intermediate_size=48), protein_embedding=64,
                      text_embedding=32, proj_dim=16, text_max_length=40, seq_max_length=96)]


@pytest.mark.parametrize("i", range(2))
def test_flops_formulas_equal_jax(i):
    s, p = SCRIBES[i], PENCLS[i]
    ps, pp = port_config(s), port_config(p)
    assert flops.proteoscribe_forward_flops(ps, 3) == jax_flops.proteoscribe_forward_flops(s, 3)
    assert flops.esm2_forward_flops(pp.esm, 5) == jax_flops.esm2_forward_flops(p.esm, 5)
    assert flops.pencl_pair_forward_flops(pp) == jax_flops.pencl_pair_forward_flops(p)
    assert flops.pencl_esm_ff_flops_fraction(pp) == jax_flops.pencl_esm_ff_flops_fraction(p)
    for kw in ({}, {"esm_ff": False, "bert_ff": True}, {"esm_proj": True, "bert_ff": True}):
        assert (flops.pencl_int8_flops_fraction(pp, **kw)
                == jax_flops.pencl_int8_flops_fraction(p, **kw)), kw
    for kw in ({}, {"ff": False, "proj": True}, {"proj": True}):
        assert (flops.proteoscribe_int8_flops_fraction(ps, **kw)
                == jax_flops.proteoscribe_int8_flops_fraction(s, **kw)), kw
    kw = dict(batch=2, seq_len=100, dim=48, depth=3, ff_dim=96, attn_flops_per_layer=7.0,
              vocab_out=11, qkvo_mult=3)
    assert flops.transformer_forward_flops(**kw) == jax_flops.transformer_forward_flops(**kw)
    assert flops.full_attention_flops(100, 48) == jax_flops.full_attention_flops(100, 48)


def test_device_peaks_by_card_name(monkeypatch):
    """The H100 SXM's data-sheet peaks, None for a card the table lacks
    and without a card."""
    assert (flops.PEAK_BF16, flops.PEAK_INT8, flops.PEAK_BYTES) == (989e12, 1979e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flops.device_peak_flops() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert flops.device_peak_flops() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert flops.device_peak_flops() is None


def test_memory_probes():
    """The process RSS as ``tests/test_io_utils.py`` holds it; no card, no
    device memory statistics."""
    assert profiling.host_memory_mb() > 0
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


@pytest.mark.parametrize("quirk", [False, True])
def test_embedding_spectrum_report_equals_jax(quirk):
    """Sorted log singular values rtol 1e-5 (f32 SVDs in two libraries),
    RankMe rtol 1e-5."""
    z = np.random.default_rng(3).standard_normal((24, 8)).astype(np.float32)
    z[:, 5:] *= 1e-3   # a near-collapsed tail
    got = figures.embedding_spectrum_report(z, quirk_q9=quirk)
    want = jax_figures.embedding_spectrum_report(z, quirk_q9=quirk)
    np.testing.assert_allclose(got["log_sigma"], want["log_sigma"], rtol=1e-5, atol=1e-5)
    assert got["erank"] == pytest.approx(want["erank"], rel=1e-5)


def test_spectrum_png_as_jax(tmp_path):
    """A PNG of the same name where matplotlib is installed, None from both
    where it is not."""
    log_sigma = np.linspace(1.0, -3.0, 16)
    got = figures.save_spectrum_png(log_sigma, "protein", str(tmp_path / "port"))
    want = jax_figures.save_spectrum_png(log_sigma, "protein", str(tmp_path / "jax"))
    assert (got is None) == (want is None)
    if got is not None:
        assert pathlib.Path(got).name == pathlib.Path(want).name == "spectrum_protein.png"
        assert pathlib.Path(got).stat().st_size > 0


def test_decode_trajectory_equals_jax():
    traj = np.random.default_rng(4).integers(0, 29, (9, 3, 40))
    for sample, every in ((0, 1), (2, 4)):
        assert (animation.decode_trajectory(traj, sample, every=every)
                == jax_animation.decode_trajectory(traj, sample, every=every))


def test_text_animation_equals_jax(tmp_path):
    """The GIF's bytes equal JAX's where pillow and imageio are installed;
    both raise the same ImportError where not."""
    texts = jax_animation.decode_trajectory(np.random.default_rng(5).integers(0, 29, (3, 1, 30)))
    outs = []
    for name, module in (("port", animation), ("jax", jax_animation)):
        try:
            module.generate_text_animation(texts, str(tmp_path / f"{name}.gif"),
                                           str(tmp_path / f"{name}_frames"))
            outs.append((tmp_path / f"{name}.gif").read_bytes())
        except ImportError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


def test_mnist_copy_equals_the_jax_package():
    """``data/mnist_data.py`` imports nothing of either package: the port's
    file is the JAX package's."""
    assert ((REPO / "biom3_tpu_torch" / "data" / "mnist_data.py").read_text()
            == (REPO / "biom3_tpu" / "data" / "mnist_data.py").read_text())
