"""Inpainting in biom3_tpu_torch against the JAX package, on the CPU in f32:
``diffusion/inpainting.py`` (``make_inpainter`` in path and confidence
order, both apply contracts, chunked with early exit; ``autocomplete``;
``corrupt_samples``; ``extract_samples_with_labels``), the chunk stepper's
``x_new`` admission, the continuous scheduler's inpaint-row layout,
``Stage3Vocab.encode_partial`` and ``ProteoScribeEngine.inpaint_batch``.

A tiny ProteoScribe (L=32, depth 2), Flax-initialised with a fixed key and
perturbed from a numpy seed, is carried to the port by ``io/from_jax.py``.
At temperature 0 every route is RNG-free, so the ids must equal the JAX
package's; at temperature > 0 the tests check the committed positions,
that every masked position is filled, and per-row reproducibility.
Logits and probabilities compare at atol 2e-4 / rtol 1e-3.
"""

import json
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import ProteoScribeConfig
from biom3_tpu.diffusion import inpainting as jax_inpainting
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu_torch.diffusion import inpainting
from biom3_tpu_torch.io.from_jax import port_config, proteoscribe_from_jax
from biom3_tpu_torch.models.fused_forward import make_stack_apply

SMALL = ProteoScribeConfig(
    num_classes=29, dim=32, depth=2, n_blocks=1, heads=4, local_heads=2,
    local_window=8, max_seq_len=32, num_timesteps=32, cond_dim=16,
)
L, C = SMALL.max_seq_len, SMALL.num_classes
TOL = dict(atol=2e-4, rtol=1e-3)
STAGE3 = {"diffusion_steps": 32, "num_classes": 29, "text_emb_dim": 16, "transformer_dim": 32,
          "transformer_heads": 4, "transformer_depth": 2, "transformer_blocks": 1,
          "transformer_local_heads": 2, "transformer_local_size": 8}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """Flax ProteoScribe at SMALL with perturbed params, its port, z_c."""
    rng = np.random.default_rng(0)
    model = JaxProteoScribe(SMALL)
    variables = model.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, SMALL.cond_dim)))
    variables = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), variables)
    z = rng.standard_normal((3, SMALL.cond_dim)).astype(np.float32)
    return model, variables, proteoscribe_from_jax(variables, port_config(SMALL)), z


def _corrupted(seed: int, B: int = 3):
    """Real ids, per-row paths and t0 (row B-1 fully revealed, t0 = L), and
    the masked ids: kept where path < t0."""
    rng = np.random.default_rng(seed)
    real = rng.integers(1, C, (B, L)).astype(np.int32)
    path = np.stack([rng.permutation(L) for _ in range(B)]).astype(np.int32)
    t0 = np.array([L // 2, L // 4, L][:B], np.int32)
    return real, path, t0, np.where(path < t0[:, None], real, 0).astype(np.int32)


def _jax_apply(model, takes_positions):
    if not takes_positions:
        return model.apply
    return lambda p, x, t, zc, pos: jnp.take_along_axis(model.apply(p, x, t, zc),
                                                        pos[..., None], axis=1)


def _port_apply(port, takes_positions):
    if takes_positions:
        return make_stack_apply(port, dtype=torch.float32, gelu="erf")
    return torch.no_grad()(port)


# --- make_inpainter: ids equal to JAX's at temperature 0 ----------------------

@pytest.mark.parametrize("takes_positions", [False, True])
@pytest.mark.parametrize("order", ["path", "confidence"])
def test_make_inpainter_temp0_ids_equal_jax(models, order, takes_positions):
    """JAX ``make_inpainter`` on the Flax graph (full logits, or gathered at
    the decode positions) against the port's on the module or the stack
    forward's plain versions, unchunked and chunked (with early exit in
    confidence order); committed positions never change, a fully revealed
    row no-ops."""
    model, variables, port, z = models
    real, path, t0, masked = _corrupted(3 if order == "path" else 4)
    B = masked.shape[0]
    jax_inpaint = jax_inpainting.make_inpainter(
        _jax_apply(model, takes_positions), L, temperature=0.0, order=order,
        apply_takes_positions=takes_positions)
    want = np.asarray(jax_inpaint(variables, jnp.asarray(masked), jnp.asarray(z[:B]),
                                  jnp.asarray(path), jnp.asarray(t0), jax.random.key(0)))
    apply = _port_apply(port, takes_positions)
    for chunk in (None, 8):
        inpaint = inpainting.make_inpainter(
            apply, L, temperature=0.0, order=order, apply_takes_positions=takes_positions,
            chunk_steps=chunk, early_exit=chunk is not None and order == "confidence")
        got = inpaint(_t(masked), _t(z[:B]), _t(path), _t(t0)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"chunk {chunk}")
    np.testing.assert_array_equal(got[masked != 0], masked[masked != 0])
    np.testing.assert_array_equal(got[-1], real[-1])
    assert (got[:-1] != masked[:-1]).any()


def test_confidence_order_on_fixed_logits_equals_jax():
    """JAX's own toy (class 1 everywhere, peakedness rising with the
    position): fills most-certain first, keeps revealed positions, no-ops
    a fully revealed row; the same ids as the JAX inpainter."""
    B, Lt, V = 3, 16, 6
    peak = np.linspace(1.0, 8.0, Lt, dtype=np.float32)
    grid = np.zeros((B, Lt, V), np.float32)
    grid[..., 1] = peak
    masked = np.array([[0] * Lt, [5] * 8 + [0] * 8, [4] * Lt], np.int32)
    seen = []

    def apply(x, t, zc):
        seen.append(t.clone())
        return _t(grid)

    got = inpainting.make_inpainter(apply, Lt, temperature=0.0, order="confidence")(
        _t(masked), None, torch.zeros(B, Lt, dtype=torch.int32), torch.zeros(B)).numpy()
    want = np.asarray(jax_inpainting.make_inpainter(
        lambda p, x, t, zc: jnp.asarray(grid), Lt, temperature=0.0, order="confidence")(
        None, jnp.asarray(masked), None, jnp.zeros((B, Lt), jnp.int32),
        jnp.zeros((B,), jnp.int32), jax.random.key(0)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], [5] * 8 + [1] * 8)
    np.testing.assert_array_equal(got[2], [4] * Lt)
    # the timestep is the revealed count, clamped to L - 1 (not the step)
    np.testing.assert_array_equal(seen[0].numpy(), [0, 8, Lt - 1])
    np.testing.assert_array_equal(seen[3].numpy(), [3, 11, Lt - 1])


def test_early_exit_skips_a_fully_revealed_batch_and_checks_arguments():
    """Early exit is a pure saving: a batch with nothing masked makes no
    forward at all.  The argument checks are JAX's."""
    def explode(*a):
        raise AssertionError("a forward on a fully revealed batch")

    real = np.random.default_rng(1).integers(1, C, (2, L)).astype(np.int32)
    inpaint = inpainting.make_inpainter(explode, L, temperature=0.0, order="confidence",
                                        chunk_steps=8, early_exit=True)
    out = inpaint(_t(real), None, torch.zeros(2, L, dtype=torch.int32), torch.zeros(2))
    np.testing.assert_array_equal(out.numpy(), real)
    with pytest.raises(ValueError, match="early_exit needs chunk_steps"):
        inpainting.make_inpainter(explode, L, early_exit=True)
    with pytest.raises(ValueError, match="not divisible by chunk_steps"):
        inpainting.make_inpainter(explode, L, chunk_steps=5)
    with pytest.raises(ValueError, match="order must be"):
        inpainting.make_inpainter(explode, L, order="random")
    with pytest.raises(ValueError, match="generator or key_data"):
        inpainting.make_inpainter(explode, L)(_t(real), None, _t(real), torch.zeros(2))


@pytest.mark.parametrize("order", ["path", "confidence"])
def test_inpainter_at_temperature_keeps_rows_and_reproduces(models, order):
    """Temperature 1 with top-k: committed ids kept, every masked position
    filled (class 0 suppressed), a row's fills a function of its key
    alone (the same row in another batch mix), and a seeded generator
    repeats."""
    _, _, port, z = models

    def apply(x, t, zc, pos):
        lg = port(x, t, zc, positions=pos)
        return lg.masked_fill(torch.arange(C) == 0, -1e9)

    real, path, t0, masked = _corrupted(7)
    inpaint = inpainting.make_inpainter(apply, L, temperature=1.0, order=order,
                                        apply_takes_positions=True, top_k=5)
    kd = torch.tensor([[1, 2], [3, 4], [5, 6]])
    a = inpaint(_t(masked), _t(z), _t(path), _t(t0), key_data=kd)
    swap = [1, 0, 2]
    b = inpaint(_t(masked[swap]), _t(z[swap]), _t(path[swap]), _t(t0[swap]), key_data=kd[swap])
    np.testing.assert_array_equal(a.numpy()[swap], b.numpy())
    assert (a.numpy() != 0).all()
    np.testing.assert_array_equal(a.numpy()[masked != 0], masked[masked != 0])
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    c = inpaint(_t(masked), _t(z), _t(path), _t(t0), g())
    np.testing.assert_array_equal(c.numpy(), inpaint(_t(masked), _t(z), _t(path), _t(t0),
                                                      g()).numpy())


# --- autocomplete, corrupt_samples, extract_samples_with_labels -------------

def test_autocomplete_ids_and_probs_equal_jax(models):
    model, variables, port, z = models
    real, path, t0, masked = _corrupted(11, B=2)
    want_ids, want_probs = jax_inpainting.autocomplete(
        model.apply, variables, jnp.asarray(masked), jnp.asarray(z[:2]), jnp.asarray(t0))
    got_ids, got_probs = inpainting.autocomplete(port, _t(masked), _t(z[:2]), _t(t0))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(want_probs), **TOL)
    drawn, _ = inpainting.autocomplete(port, _t(masked), _t(z[:2]), _t(t0),
                                       torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(drawn.numpy()[masked != 0], masked[masked != 0])


def test_corrupt_samples_masked_count():
    real = torch.full((4, 64), 7, dtype=torch.int32)
    masked, path, t = inpainting.corrupt_samples(torch.Generator().manual_seed(0), real, 0.25,
                                                 64)
    np.testing.assert_array_equal((masked != 0).sum(1).numpy(), 16)
    np.testing.assert_array_equal(t.numpy(), 16)
    assert sorted(path[0].tolist()) == list(range(64))
    jm, _, jt = jax_inpainting.corrupt_samples(jax.random.key(0), jnp.asarray(real.numpy()),
                                               0.25, 64)
    assert (np.asarray(jm) != 0).sum(1).tolist() == (masked != 0).sum(1).tolist()


def test_extract_samples_with_labels_byte_equal():
    data = np.arange(40).reshape(10, 4).astype(np.int32)
    labels = np.array([1, 0, 1, 1, 0, 2, 1, 1, 0, 1])
    for target, total, pad in ((1, 3, False), (0, 10, True), (2, 1, False), (5, 2, False)):
        got = inpainting.extract_samples_with_labels(data, labels, target, total,
                                                     pad_included=pad)
        want = jax_inpainting.extract_samples_with_labels(data, labels, target, total,
                                                          pad_included=pad)
        assert len(got["sample"]) == len(want["sample"]) and got["label"] == want["label"]
        for a, b in zip(got["sample"], want["sample"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_encode_partial_rows_equal_jax():
    from biom3_tpu.tokenizers.stage3_vocab import Stage3Vocab as JaxVocab
    from biom3_tpu_torch.tokenizers import Stage3Vocab

    mine, theirs = Stage3Vocab(), JaxVocab()
    for seq, pad, unk in (("AC?G?", 10, "?"), ("MK??ACDE??", 32, "?"), ("A_C", 8, "_"),
                          ("?" * 30, 32, "?")):
        got = mine.encode_partial(seq, pad, unk)
        want = theirs.encode_partial(seq, pad, unk)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for seq, pad, unk, msg in (("A" * 9, 10, "?", "too long"), ("AJ?", 10, "?", "invalid"),
                               ("A?", 10, "A", "unknown marker"), ("A?", 10, "??", "unknown")):
        with pytest.raises(ValueError, match=msg):
            mine.encode_partial(seq, pad, unk)
        with pytest.raises(ValueError, match=msg):
            theirs.encode_partial(seq, pad, unk)


# --- the chunk stepper's x_new and the continuous inpaint-row layout --------

@pytest.mark.parametrize("k,chunk", [(1, 8), (8, 2)])
def test_chunk_fn_x_new_equal_jax(models, k, chunk):
    """Row 0 inpaints (11 masked positions, t0 = 21: at k = 8 its last block
    straddles num_steps), row 1 generates; the port's stepper on the stack
    forward against JAX ``make_chunk_stepper`` on the Flax graph, chunk by
    chunk from fresh rows."""
    from biom3_tpu.diffusion.sampler import make_chunk_stepper as jax_stepper
    from biom3_tpu_torch.diffusion.sampler import make_chunk_stepper

    model, variables, port, z = models
    rng = np.random.default_rng(13)
    B, m = 2, 11
    masked = rng.integers(2, C, L).astype(np.int32)
    masked_pos = rng.choice(L, m, replace=False)
    masked[masked_pos] = 0
    committed = np.setdiff1d(np.arange(L), masked_pos)
    t_start = L - m
    inv = np.stack([np.concatenate([committed, rng.permutation(masked_pos)]),
                    rng.permutation(L)]).astype(np.int32)
    x_new = np.stack([masked, np.zeros(L, np.int32)])
    t0 = np.array([t_start, 0], np.int32)
    kd = np.zeros((B, 2), np.uint32)
    n_chunks = L // k // chunk

    jstep = jax_stepper(model.apply, L, chunk_steps=chunk, positions_per_step=k,
                        temperature=0.0)
    jx, jt0, fresh = jnp.zeros((B, L), jnp.int32), t0.copy(), np.ones(B, bool)
    for _ in range(n_chunks):
        jx, _ = jstep(variables, jnp.asarray(z[:B]), jnp.asarray(inv), jx, jnp.asarray(jt0),
                      jnp.asarray(kd), jnp.asarray(kd), jnp.asarray(fresh), jnp.asarray(x_new))
        # a new array, never the old one written in place: the dispatched
        # chunk may still read the host buffer it was given (the diagnosis
        # and its counts are in CHANGES.md)
        fresh = np.zeros(B, bool)
        jt0 = np.minimum(jt0 + chunk * k, L)
    want = np.asarray(jx)

    step = make_chunk_stepper(make_stack_apply(port, dtype=torch.float32, gelu="erf"), L,
                              chunk_steps=chunk, positions_per_step=k, temperature=0.0,
                              apply_takes_positions=True)
    x, pt0, fresh = torch.zeros((B, L), dtype=torch.int32), torch.from_numpy(t0).long(), \
        torch.ones(B, dtype=torch.bool)
    kdt = torch.zeros((B, 2), dtype=torch.int64)
    for _ in range(n_chunks):
        x, kdt = step(_t(z[:B]), _t(inv).long(), x, pt0, kdt, kdt, fresh, _t(x_new))
        fresh = torch.zeros(B, dtype=torch.bool)
        pt0 = (pt0 + chunk * k).clamp(max=L)
    got = x.numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0][masked != 0], masked[masked != 0])
    assert (got != 0).all()


def test_prepare_row_layout_byte_equal_jax():
    """``_prepare_row`` (masked positions on the slots the row visits, in
    its own random order; ``t_start = max(0, num_steps − m)``) against
    JAX's on the same ``inv`` and key words."""
    from biom3_tpu.serving.continuous import ContinuousGenerateBatcher as JaxContinuous
    from biom3_tpu_torch.serving.continuous import ContinuousGenerateBatcher

    rng = np.random.default_rng(2)
    inv = rng.permutation(L).astype(np.int32)
    kd = np.array([7, 9], np.uint32)
    fake = types.SimpleNamespace(_row_streams=lambda seed, rep: (inv.copy(), kd.copy()),
                                 _num_steps=L)
    rows = [rng.integers(1, C, L).astype(np.int32) for _ in range(4)]
    rows[0][rng.choice(L, 5, replace=False)] = 0
    rows[1][:] = 0
    rows[2][rng.choice(L, 31, replace=False)] = 0
    for mids in [None] + rows:
        g = {"request": {"prompt": "p", "seed": 3, "masked_ids": mids}}
        got = ContinuousGenerateBatcher._prepare_row(fake, g, 1)
        want = JaxContinuous._prepare_row(fake, g, 1)
        for a, b in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        if mids is not None:
            m = int((mids == 0).sum())
            assert got[2] == max(0, L - m)
            assert set(got[0][got[2]:got[2] + m]) == set(np.flatnonzero(mids == 0))


# --- the engine --------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX engine's seeded init exported to a reference-layout .bin, and
    the config both engines read."""
    from biom3_tpu.config import Config as JaxConfig
    from biom3_tpu.io.export import proteoscribe_params_to_torch
    from biom3_tpu.io.torch_load import save_torch_file
    from biom3_tpu.pipeline.stage3 import ProteoScribeEngine as JaxEngine

    root = tmp_path_factory.mktemp("inpaint_engine")
    (root / "s3.json").write_text(json.dumps(STAGE3))
    j3 = JaxEngine(JaxConfig(STAGE3))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * np.random.default_rng(5).standard_normal(p.shape).astype(
            np.float32), j3.params)
    save_torch_file(proteoscribe_params_to_torch(params, j3.config), root / "s3.bin")
    return root


@pytest.mark.parametrize("mode", [dict(), dict(sampler_mode="maskgit", maskgit_steps=4)])
def test_engine_inpaint_batch_equal_jax(engines, mode):
    """``inpaint_batch`` at temperature 0: the JAX engine (Flax graph) against
    the port's on the stack forward's plain versions, the confidence
    inpainter chunked at 8 positions with early exit (ARDM) or MaskGIT
    resuming from the partial rows; committed ids kept, all filled."""
    from biom3_tpu.config import load_json_config as jax_load
    from biom3_tpu.pipeline.stage3 import ProteoScribeEngine as JaxEngine
    from biom3_tpu_torch.config import load_json_config
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    root = engines
    kw = dict(temperature=0.0, chunk_steps=8, **mode)
    j3 = JaxEngine(jax_load(root / "s3.json"), str(root / "s3.bin"), **kw)
    p3 = ProteoScribeEngine(load_json_config(root / "s3.json"), str(root / "s3.bin"),
                            device="cpu", use_stack=True, **kw)
    masked = np.stack([p3.vocab.encode_partial("AC?G?MK?", L),
                       p3.vocab.encode_partial("??????", L),
                       p3.vocab.encode_partial("MKV" * 10, L)])
    z_c = np.random.default_rng(6).standard_normal((3, 16)).astype(np.float32)
    want = j3.inpaint_batch(masked, z_c, jax.random.key(1))
    got = p3.inpaint_batch(masked, z_c)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[masked != 0], masked[masked != 0])
    assert (got != 0).all()
    if not mode:
        assert p3._inpainter is not None and p3._chunk_steps_arg == 8
