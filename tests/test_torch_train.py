"""biom3_tpu_torch Stage-3 training vs the JAX package, on the CPU in f32.

The port runs its kernels' plain versions here; the JAX side runs its
Pallas training kernels in interpret mode (``attn_block``, ``layer_block``)
or the Flax graph.  Inputs, paths and timesteps come from numpy with a
seed and go to both sides.  Tolerances are stated per test: those of the
JAX package's own kernel tests (``tests/test_layer_block.py``,
``tests/test_attn_block.py``) where the port is held against the same
kernel; f32 on both sides, different summation orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from biom3_tpu.config import Config as JaxConfig
from biom3_tpu.config import ProteoScribeConfig as JaxProteoScribeConfig
from biom3_tpu.data.loader import BatchLoader as JaxBatchLoader
from biom3_tpu.data.stage3_data import (
    Stage3Dataset as JaxStage3Dataset,
    merge_data_dicts as jax_merge_data_dicts,
    prepare_protein_data as jax_prepare_protein_data,
)
from biom3_tpu.diffusion import oa_ardm as jax_oa
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.ops.pallas.attn_block_tpu import split_attention_block as jax_attn_block
from biom3_tpu.ops.pallas.layer_block_tpu import transformer_layer_block as jax_layer_block
from biom3_tpu.training import metrics as jax_metrics
from biom3_tpu.training.ema import ema_update as jax_ema_update
from biom3_tpu.training.optim import (
    coswarmup_schedule as jax_coswarmup,
    exponential_epoch_schedule as jax_exponential,
)
from biom3_tpu_torch.config import Config, ProteoScribeConfig
from biom3_tpu_torch.data.loader import BatchLoader
from biom3_tpu_torch.data.stage3_data import Stage3Dataset, merge_data_dicts, prepare_protein_data
from biom3_tpu_torch.diffusion import oa_ardm
from biom3_tpu_torch.io.from_jax import proteoscribe_from_jax, proteoscribe_params_to_torch
from biom3_tpu_torch.models.proteoscribe import ProteoScribe
from biom3_tpu_torch.ops import kernels as K
from biom3_tpu_torch.ops.attn_block import split_attention_block
from biom3_tpu_torch.ops.layer_block import transformer_layer_block
from biom3_tpu_torch.training import metrics
from biom3_tpu_torch.training.ema import ema_update
from biom3_tpu_torch.training.optim import (
    Optimizer,
    coswarmup_schedule,
    exponential_epoch_schedule,
    make_optimizer,
)
from biom3_tpu_torch.training.stage3_task import make_stage3_train_step, stage3_loss_fn
from biom3_tpu_torch.training.state import TrainState

SMALL = dict(num_classes=29, dim=64, depth=2, n_blocks=1, heads=4, local_heads=2,
             local_window=16, max_seq_len=64, num_timesteps=64, cond_dim=16)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _layer_args(rng, d=64, ff=256):
    """xb and the 13 layer parameters, LayerNorm and biases away from 1/0."""
    return ([_np(rng, 2, 64, d, scale=0.5)]
            + [_np(rng, d, d, scale=d ** -0.5) for _ in range(4)] + [_np(rng, d, scale=0.1)]
            + [1 + _np(rng, d, scale=0.1), _np(rng, d, scale=0.1)] * 2
            + [_np(rng, d, ff, scale=d ** -0.5), _np(rng, ff, scale=0.1),
               _np(rng, ff, d, scale=ff ** -0.5), _np(rng, d, scale=0.1)])


# --- the two training kernels ----------------------------------------------

@pytest.mark.parametrize("local_heads, heads, d, window", [
    pytest.param(2, 4, 64, 16, id="2"), pytest.param(0, 4, 64, 16, id="0"),
    pytest.param(4, 4, 64, 16, id="4"),
    # the head dims the card's kernels take (32, 64), each with a window
    # under the 64-row tile, beside a linear head
    pytest.param(1, 2, 64, 16, id="dh32-w16"), pytest.param(1, 2, 128, 32, id="dh64-w32"),
])
def test_layer_block_matches_jax(local_heads, heads, d, window):
    """Forward at tests/test_layer_block.py's tolerance (atol 3e-5, rtol
    1e-4); loss rtol/atol 2e-4, dx atol 2e-4 rtol 2e-3, each parameter
    gradient atol 5e-4·max|g| rtol 3e-3.  The attention backward inside is
    ``stage3_attention_bwd_plain``, against JAX ``_bwd_call`` in
    interpret mode."""
    rng = np.random.default_rng(10 + local_heads)
    args = _layer_args(rng, d=d)
    cot = _np(rng, 2, 64, d)
    kw = dict(local_heads=local_heads, heads=heads, window=window)

    def jax_loss(*a):
        out = jax_layer_block(*a, **kw, ff_block_l=32, interpret=True)
        return jnp.sum(out * cot), out

    (want_val, want_out), want_g = jax.value_and_grad(jax_loss, argnums=tuple(range(14)),
                                                      has_aux=True)(*map(jnp.asarray, args))
    ts = [_t(a, grad=True) for a in args]
    out = transformer_layer_block(*ts, **kw)
    val = (out * _t(cot)).sum()
    val.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(float(val.detach()), float(want_val), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ts[0].grad.numpy(), np.asarray(want_g[0]), atol=2e-4, rtol=2e-3)
    for i, (t, g) in enumerate(zip(ts[1:], want_g[1:]), 1):
        scale = max(1e-3, float(jnp.abs(g).max()))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=5e-4 * scale, rtol=3e-3,
                                   err_msg=f"argument {i}")


@pytest.mark.parametrize("local_heads", [0, 2, 4])
def test_split_attention_block_matches_jax(local_heads):
    """tests/test_attn_block.py's tolerances: value rtol/atol 2e-4, every
    gradient atol 5e-4·max|g| rtol 2e-3."""
    rng = np.random.default_rng(20 + local_heads)
    args = [_np(rng, 2, 64, 64, scale=0.3)] + [_np(rng, 64, 64, scale=0.3) for _ in range(4)]
    args.append(_np(rng, 64, scale=0.3))
    cot = _np(rng, 2, 64, 64)
    kw = dict(local_heads=local_heads, heads=4, window=16)

    def jax_loss(*a):
        return jnp.sum(jax_attn_block(*a, **kw, interpret=True) * cot)

    want_val, want_g = jax.value_and_grad(jax_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    ts = [_t(a, grad=True) for a in args]
    val = (split_attention_block(*ts, **kw) * _t(cot)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(want_val), rtol=2e-4, atol=2e-4)
    for name, t, g in zip(["dxn", "dwq", "dwk", "dwv", "dwo", "dbo"], ts, want_g):
        scale = max(1e-3, float(jnp.abs(g).max()))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=5e-4 * scale, rtol=2e-3,
                                   err_msg=name)


def test_blocks_check_window_divides_length():
    rng = np.random.default_rng(3)
    args = [_t(a) for a in _layer_args(rng)]
    with pytest.raises(ValueError, match="L % window"):
        transformer_layer_block(*args, local_heads=2, heads=4, window=24)
    with pytest.raises(ValueError, match="L % window"):
        split_attention_block(args[0], *args[1:6], local_heads=2, heads=4, window=24)


# --- each plain backward against autograd of its plain forward ---------------
# f32 on both sides; atol 1e-5 / rtol 1e-4 (the same arithmetic, other orders)

PLAIN_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("local_heads", [0, 2, 4])
def test_stage3_attention_bwd_plain_is_the_gradient(local_heads):
    rng = np.random.default_rng(30 + local_heads)
    qkv, da = _t(_np(rng, 2, 64, 192), grad=True), _t(_np(rng, 2, 64, 64))
    kw = dict(heads=4, local_heads=local_heads, window=16)
    want, = torch.autograd.grad(K.stage3_attention_core_plain(qkv, **kw), qkv, da)
    got = K.stage3_attention_bwd(qkv.detach(), da, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PLAIN_TOL)


def test_layernorm_bwd_plain_is_the_gradient():
    rng = np.random.default_rng(4)
    x, s, b = (_t(a, grad=True) for a in (_np(rng, 37, 64, scale=2.0),
                                          1 + _np(rng, 64, scale=0.1), _np(rng, 64)))
    dy, res = _t(_np(rng, 37, 64)), _t(_np(rng, 37, 64))
    want = torch.autograd.grad(K.layernorm_plain(x, s, b, eps=1e-6, out_dtype=torch.float32),
                               (x, s, b), dy)
    (dx, dx_cd), ds, db = K.layernorm_bwd(x.detach(), dy, s.detach(), residual=res,
                                          out_dtype=torch.float32, want_cd=True)
    np.testing.assert_allclose((dx - res).numpy(), want[0].numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(dx_cd.numpy(), dx.numpy())
    np.testing.assert_allclose(ds.numpy(), want[1].numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(db.numpy(), want[2].numpy(), **PLAIN_TOL)


# (gelu, rows, d, ff): the FF sub-block's widths; "tanh-esm-ragged" has an
# ESM2-like 1:4 FF ratio and a row count off every tile
@pytest.mark.parametrize("gelu, rows, d, ff", [
    pytest.param("erf", 40, 16, 32, id="erf"),
    pytest.param("tanh", 40, 16, 32, id="tanh"),
    pytest.param("tanh", 37, 40, 160, id="tanh-esm-ragged"),
])
def test_gemm_backward_plains_are_the_gradients(gelu, rows, d, ff):
    """gemm_dx (with the GELU-derivative epilogue), gemm_dw and col_sum
    against autograd of gemm_bias_act_plain through x·W1 → GELU → ·W2."""
    rng = np.random.default_rng(5)
    a, w, bias = (_t(x, grad=True) for x in (_np(rng, rows, 24), _np(rng, 24, ff), _np(rng, ff)))
    w2, dy = _t(_np(rng, ff, d)), _t(_np(rng, rows, d))
    y, h = K.gemm_bias_act_plain(a, w, bias, act=gelu, want_pre=True)
    ga, gw, gb = torch.autograd.grad(K.gemm_bias_act_plain(y, w2), (a, w, bias), dy)
    dh = K.gemm_dx(dy, w2, gelu_of=h.detach(), gelu=gelu)
    np.testing.assert_allclose(K.gemm_dx(dh, w.detach()).numpy(), ga.numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(K.gemm_dw(a.detach(), dh).numpy(), gw.numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(K.col_sum(dh).numpy(), gb.numpy(), **PLAIN_TOL)


@pytest.mark.parametrize("rows, k, n, sms", [
    (4096, 512, 512, 132), (4096, 2048, 512, 132), (4096, 512, 1536, 132),
    (32768, 512, 512, 132), (4096, 5120, 1280, 132), (4096, 1280, 1280, 132),
    (1000, 264, 200, 132), (37, 264, 200, 132), (130, 64, 64, 114), (8191, 512, 512, 16),
])
def test_gemm_dw_split_rule_covers_every_row_once(rows, k, n, sms):
    """gemm_dw's splits are whole 64-row k-tiles, none empty, and each row
    lies in exactly one; output tiles times splits fill at most one wave of
    two blocks an SM (or one split where the tiles alone exceed it)."""
    bm, splits, chunk = K.gemm_dw_plan(rows, k, n, sms)
    assert bm in (64, 128) and chunk % 64 == 0 and splits >= 1
    starts = range(0, splits * chunk, chunk)
    counts = np.zeros(rows, int)
    for s0 in starts:
        assert s0 < rows                                  # no empty split
        counts[s0:min(rows, s0 + chunk)] += 1
    assert (counts == 1).all()
    tiles = -(-k // bm) * -(-n // 128)
    assert splits == 1 or tiles * splits <= 2 * sms
    assert splits == 1 or chunk >= K.DW_MIN_KTILES * 64


# (rows, n, sms, tile rows): the Stage-3 and ESM2 products' outputs and the
# tile each measured fastest with on an H100 (PERF.md), then the rule's edge
@pytest.mark.parametrize("rows, n, sms, bm", [
    (4096, 512, 132, 64), (4096, 2048, 132, 128), (32768, 512, 132, 128),
    (32768, 2048, 132, 128), (2048, 1280, 132, 128), (2048, 5120, 132, 128),
    (4096, 1280, 132, 128), (37, 5120, 132, 64), (1000, 200, 132, 64),
    (4224, 512, 132, 128), (4223, 512, 132, 128), (4096, 512, 128, 128),
])
def test_gemm_dx_tile_rule(rows, n, sms, bm):
    """gemm_dx takes 128x128 tiles exactly where they cover every SM."""
    assert K.gemm_dx_plan(rows, n, sms) == bm
    assert (bm == 128) == (-(-rows // 128) * -(-n // 128) >= sms)


# --- the model, the objective and the whole loss gradient -------------------

@pytest.fixture(scope="module")
def jax_model():
    """Flax ProteoScribe at SMALL (f32 graph) with perturbed params, a batch
    of PAD-tailed shifted tokens and numpy paths/timesteps."""
    rng = np.random.default_rng(0)
    cfg = JaxProteoScribeConfig(**SMALL)
    model = JaxProteoScribe(cfg)
    B, L = 3, cfg.max_seq_len
    variables = model.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.cond_dim)))
    variables = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), variables)
    tokens = np.full((B, L), 23, np.int32)
    for b, n in enumerate((40, 62, 10)):
        tokens[b, 0], tokens[b, 1:n + 1], tokens[b, n + 1] = 1, rng.integers(2, 22, n), 22
    path = np.stack([rng.permutation(L) for _ in range(B)]).astype(np.int32)
    t = np.array([0, 30, L], np.int32)
    z = _np(rng, B, cfg.cond_dim)
    return model, variables, tokens, path, t, z


@pytest.mark.parametrize("attn_impl", ["plain", "block", "layer-block"])
def test_proteoscribe_loss_and_gradients_match_jax(jax_model, attn_impl):
    """Loss rtol 1e-4; every parameter gradient atol 5e-4·max|g| rtol 3e-3
    (tests/test_layer_block.py's gradient tolerance)."""
    model, variables, tokens, path, t, z = jax_model

    def jax_loss(v):
        masked = jax_oa.mask_realizations(jnp.asarray(tokens), jnp.asarray(path), jnp.asarray(t))
        logits = model.apply(v, masked, jnp.asarray(t), jnp.asarray(z))
        return jax_oa.oa_ardm_loss(logits, jnp.asarray(tokens), masked, jnp.asarray(t))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(variables)
    cfg = ProteoScribeConfig(**SMALL)
    port = ProteoScribe(cfg, attn_impl=attn_impl)
    port.load_state_dict(proteoscribe_from_jax(variables, cfg).state_dict())
    port.train()
    loss, aux = stage3_loss_fn(port, torch.from_numpy(tokens).long(), torch.from_numpy(z),
                               path=torch.from_numpy(path).long(),
                               t=torch.from_numpy(t).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    want = proteoscribe_params_to_torch(jax.tree_util.tree_map(np.asarray, want_grads), cfg)
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name]).reshape(g.shape)
        scale = max(1e-3, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4 * scale, rtol=3e-3, err_msg=name)


def test_layer_block_refuses_dropout_in_train_mode():
    cfg = ProteoScribeConfig(**SMALL, attn_layer_dropout=0.1)
    model = ProteoScribe(cfg, attn_impl="layer-block").train()
    x = torch.zeros((1, 64), dtype=torch.long)
    with pytest.raises(ValueError, match="no dropout path"):
        model(x, torch.zeros(1, dtype=torch.long), torch.zeros(1, 16))
    model.eval()(x, torch.zeros(1, dtype=torch.long), torch.zeros(1, 16))


def test_mask_and_loss_equal_jax():
    """Exact masks; loss rtol 1e-6 (the same f32 log-softmax)."""
    rng = np.random.default_rng(6)
    B, L = 4, 32
    tokens = rng.integers(1, 29, (B, L)).astype(np.int32)
    path = np.stack([rng.permutation(L) for _ in range(B)]).astype(np.int32)
    t = np.array([0, 5, 31, 32], np.int32)
    logits = _np(rng, B, L, 29)
    want = np.asarray(jax_oa.mask_realizations(tokens, path, t))
    got = oa_ardm.mask_realizations(*map(torch.from_numpy, (tokens, path, t)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        float(oa_ardm.oa_ardm_loss(torch.from_numpy(logits), torch.from_numpy(tokens), got,
                                   torch.from_numpy(t))),
        float(jax_oa.oa_ardm_loss(logits, tokens, want, t)), rtol=1e-6)


def test_path_and_timestep_samplers():
    g = torch.Generator().manual_seed(0)
    path = oa_ardm.sample_random_paths(g, 8, 50)
    assert path.shape == (8, 50)
    assert (path.sort(-1).values == torch.arange(50)).all()
    for option in ("random", "weighted"):
        t = oa_ardm.sample_timesteps(g, 4000, 50, option=option)
        assert t.shape == (4000,) and int(t.min()) >= 0 and int(t.max()) <= 50
        assert len(set(t.tolist())) > 40
    weighted = oa_ardm.sample_timesteps(g, 4000, 1000, option="weighted", decay_rate=0.005)
    assert float(weighted.float().mean()) < 300  # mean of the truncated exponential ≈ 199
    with pytest.raises(ValueError):
        oa_ardm.sample_timesteps(g, 1, 5, option="other")


# --- optimizer, schedules, EMA, accumulation ----------------------------------

@pytest.mark.parametrize("name,wd", [("AdamW", 0.1), ("Adam", 0.0)])
def test_optimizer_matches_optax(name, wd):
    """3 steps on the same gradients: atol 1e-6 (f32 elementwise)."""
    rng = np.random.default_rng(7)
    p0 = _np(rng, 5, 3)
    grads = [_np(rng, 5, 3) for _ in range(3)]
    tx = optax.adamw(1e-2, weight_decay=wd) if name == "AdamW" else optax.adam(1e-2)
    p, st = jnp.asarray(p0), None
    st = tx.init(p)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(name, [param], 1e-2, weight_decay=wd)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        param.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p), atol=1e-6)
    # Adafactor is ported (held against optax in tests/test_torch_optim.py);
    # an unknown name is refused
    assert type(make_optimizer("Adafactor", [param], 1e-2).opt).__name__ == "Adafactor"
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("Lion", [param], 1e-2)


@pytest.mark.parametrize("kind", ["coswarmup", "exponential"])
def test_schedules_match_jax_over_three_epochs(kind):
    """The rate at every optimizer step of 3 epochs, as LambdaLR steps it:
    rtol 1e-6."""
    spe, base = 7, 3e-4
    if kind == "coswarmup":
        mine, ref = coswarmup_schedule(spe, 3 * spe), jax_coswarmup(base, spe, 3 * spe)
    else:
        mine, ref = exponential_epoch_schedule(0.5, spe), jax_exponential(base, 0.5, spe)
    param = torch.nn.Parameter(torch.zeros(1))
    opt = Optimizer(torch.optim.SGD([param], lr=base), mine, None)
    for step in range(3 * spe):
        np.testing.assert_allclose(opt.opt.param_groups[0]["lr"], float(ref(step)), rtol=1e-6,
                                   atol=1e-12)
        param.grad = torch.zeros(1)
        opt.step()


def test_ema_matches_jax():
    rng = np.random.default_rng(8)
    ema, params = [_np(rng, 4, 3), _np(rng, 7)], [_np(rng, 4, 3), _np(rng, 7)]
    want = jax_ema_update(ema, params, 0.99)
    got = [torch.from_numpy(e.copy()) for e in ema]
    ema_update(got, [torch.from_numpy(p) for p in params], 0.99)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_accumulation_is_the_mean_of_microbatches():
    """accum 2 over a batch of 4 = the mean of the two microbatch gradients
    (SGD, lr 1: the step is minus the gradient); atol 1e-6."""
    cfg = ProteoScribeConfig(**SMALL)
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(1, 29, (4, 64))).long()
    z = torch.from_numpy(_np(rng, 4, 16))
    model = ProteoScribe(cfg)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState(model, Optimizer(torch.optim.SGD(model.parameters(), lr=1.0), None, None))
    make_stage3_train_step(state, accum_steps=2)({"tokens": tokens, "z_c": z},
                                                 torch.Generator().manual_seed(1))
    ref = ProteoScribe(cfg)
    ref.load_state_dict(start)
    ref.train()
    g = torch.Generator().manual_seed(1)
    for sl in (slice(0, 2), slice(2, 4)):
        loss, _ = stage3_loss_fn(ref, tokens[sl], z[sl], generator=g)
        (loss / 2).backward()
    assert state.step == 1
    for n, p in model.named_parameters():
        np.testing.assert_allclose((start[n] - p.detach()).numpy(),
                                   ref.get_parameter(n).grad.numpy(), atol=1e-6, err_msg=n)


# --- data and metrics -----------------------------------------------------------

def test_stage3_data_and_loader_match_jax():
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWYXUZBO"), int(n)))
            for n in rng.integers(1, 70, 12)] + ["AC-D-E"]
    data = {"sequence": seqs, "text_to_protein_embedding": list(_np(rng, 13, 8))}
    other = {"sequence": seqs[:3], "text_to_protein_embedding": list(_np(rng, 3, 8))}
    args = {"diffusion_steps": 64, "image_size": 8, "facilitator": "MMD"}
    merged, jmerged = merge_data_dicts(data, other), jax_merge_data_dicts(data, other)
    assert sorted(merged) == sorted(jmerged)
    for k in merged:
        assert len(merged[k]) == len(jmerged[k])
    got = prepare_protein_data(Config(args), merged)
    want = jax_prepare_protein_data(JaxConfig(args), jmerged)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    split, jsplit = Stage3Dataset(*got, valid_size=0.25), JaxStage3Dataset(*want, valid_size=0.25)
    for which in ("train", "val"):
        for a, b in zip(split.split(which), jsplit.split(which)):
            np.testing.assert_array_equal(a, b)
    order = [b["i"].tolist() for _ in range(2)
             for b in BatchLoader(13, 4, lambda i: {"i": i}, seed=3)]
    jorder = [b["i"].tolist() for _ in range(2)
              for b in JaxBatchLoader(13, 4, lambda i: {"i": i}, seed=3)]
    assert order == jorder


def test_stage3_metrics_match_jax():
    """rtol 1e-5 (f32 reductions in other orders)."""
    rng = np.random.default_rng(12)
    B, L, C = 3, 40, 29
    probs = np.asarray(jax.nn.softmax(_np(rng, B, L, C, scale=3.0), axis=-1))
    pred, real = rng.integers(0, C, (B, L)), rng.integers(20, 26, (B, L))
    real[1] = 23
    path = np.stack([rng.permutation(L) for _ in range(B)])
    t = np.array([0, 17, L])
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pairs = [(metrics.entropy_ppl(T(probs)), jax_metrics.entropy_ppl(probs)),
             (metrics.hard_accuracy(T(pred), T(real)), jax_metrics.hard_accuracy(pred, real)),
             (metrics.positional_entropy(T(probs)), jax_metrics.positional_entropy(probs))]
    got = metrics.time_split_metrics(T(pred), T(real), T(probs), T(path), T(t))
    want = jax_metrics.time_split_metrics(pred, real, probs, path, t)
    assert sorted(got) == sorted(want)
    pairs += [(got[k], want[k]) for k in got]
    for a, b in pairs:
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
