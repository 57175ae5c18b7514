"""biom3_tpu_torch Stage 3 vs the JAX package, on the CPU in f32.

The port runs its kernels' plain versions here; the JAX side runs its
Pallas kernels in interpret mode (or the Flax graph).  Inputs come from
numpy with a seed; weights reach the port through ``io/from_jax.py``.
Tolerance atol 2e-4 / rtol 1e-3: f32 on both sides, different summation
orders (the JAX twins' own tests use 2e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import ProteoScribeConfig
from biom3_tpu.diffusion.sampler import make_sampler as jax_make_sampler
from biom3_tpu.models.fused_forward import make_stack_apply as jax_make_stack_apply
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.ops.pallas.fused_layer_tpu import (
    fused_attn_half as jax_fused_attn_half,
    fused_ff_half as jax_fused_ff_half,
)
from biom3_tpu_torch.diffusion.sampler import make_sampler
from biom3_tpu_torch.io.from_jax import proteoscribe_from_jax
from biom3_tpu_torch.models.fused_forward import make_stack_apply
from biom3_tpu_torch.ops.stage3_layer import fused_attn_half, fused_ff_half

SMALL = ProteoScribeConfig(
    num_classes=29, dim=64, depth=3, n_blocks=1, heads=4, local_heads=2,
    local_window=32, max_seq_len=128, num_timesteps=128, cond_dim=48,
)
TOL = dict(atol=2e-4, rtol=1e-3)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_model():
    """Flax ProteoScribe at SMALL with its params, and the port's twin."""
    rng = np.random.default_rng(0)
    model = JaxProteoScribe(SMALL)
    B, L = 4, SMALL.max_seq_len
    variables = model.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, SMALL.cond_dim)))
    # biases and norm parameters are initialised to 0/1: perturb them so
    # the comparison sees every parameter
    variables = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), variables)
    x = rng.integers(0, 29, (B, L)).astype(np.int32)
    t = rng.integers(0, SMALL.num_timesteps, (B,)).astype(np.int32)
    z = _np(rng, B, SMALL.cond_dim)
    return model, variables, proteoscribe_from_jax(variables, SMALL), x, t, z


def test_fused_attn_half_matches_jax():
    rng = np.random.default_rng(1)
    B, L, d = 2, SMALL.max_seq_len, SMALL.dim
    args = [_np(rng, B, L, d), _np(rng, B, d), 1 + _np(rng, d, scale=0.1), _np(rng, d, scale=0.1)]
    args += [_np(rng, d, d, scale=d ** -0.5) for _ in range(4)] + [_np(rng, d, scale=0.1)]
    kw = dict(local_heads=SMALL.local_heads, heads=SMALL.heads, window=SMALL.local_window)
    want = np.asarray(jax_fused_attn_half(*map(jnp.asarray, args), **kw, interpret=True))
    got = fused_attn_half(*map(_t, args), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_fused_ff_half_matches_jax(gelu):
    rng = np.random.default_rng(2)
    B, L, d, ff = 2, SMALL.max_seq_len, SMALL.dim, 4 * SMALL.dim
    args = [_np(rng, B, L, d), 1 + _np(rng, d, scale=0.1), _np(rng, d, scale=0.1),
            _np(rng, d, ff, scale=d ** -0.5), _np(rng, ff, scale=0.1),
            _np(rng, ff, d, scale=ff ** -0.5), _np(rng, d, scale=0.1)]
    want = np.asarray(jax_fused_ff_half(*map(jnp.asarray, args), gelu=gelu, block_l=64,
                                        interpret=True))
    got = fused_ff_half(*map(_t, args), gelu=gelu).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 8])
def test_fused_stack_logits_matches_jax(jax_model, k):
    _, variables, port, x, t, z = jax_model
    rng = np.random.default_rng(3 + k)
    pos = np.stack([rng.permutation(SMALL.max_seq_len)[:k] for _ in range(x.shape[0])])
    pos = pos.astype(np.int32)
    jax_apply = jax_make_stack_apply(SMALL, dtype=jnp.float32, resident=False, interpret=True)
    want = np.asarray(jax_apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z),
                                jnp.asarray(pos)))
    got = make_stack_apply(port, dtype=torch.float32, gelu="erf")(
        _t(x), _t(t), _t(z), _t(pos)).numpy()
    assert got.shape == (x.shape[0], k, SMALL.num_classes)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_stack_logits_same_inputs_as_jax(jax_model):
    """The public counterpart on the TPU kernel's own inputs: stacked
    (depth, d_in, d_out) weights, pos (B, k), bias (B, depth, d)."""
    from biom3_tpu.ops.pallas.stack_kernel_tpu import fused_stack_logits as jax_stack

    from biom3_tpu_torch.ops.stack import fused_stack_logits

    _, variables, _, x, _, _ = jax_model
    p = variables["params"]
    layers = [p[f"layer_0_{i}"] for i in range(SMALL.depth)]
    stack = lambda get: np.stack([np.asarray(get(lp)) for lp in layers])
    pos_emb = (np.asarray(p["ax_row"])[:, None, :] + np.asarray(p["ax_col"])[None, :, :])
    arrays = [
        np.asarray(p["tok_emb"]["embedding"]), pos_emb.reshape(SMALL.max_seq_len, SMALL.dim),
        stack(lambda lp: lp["attn_norm"]["scale"]), stack(lambda lp: lp["attn_norm"]["bias"]),
        stack(lambda lp: lp["attn"]["to_q_kernel"]), stack(lambda lp: lp["attn"]["to_k_kernel"]),
        stack(lambda lp: lp["attn"]["to_v_kernel"]),
        stack(lambda lp: lp["attn"]["to_out"]["kernel"]),
        stack(lambda lp: lp["attn"]["to_out"]["bias"]),
        stack(lambda lp: lp["ff_norm"]["scale"]), stack(lambda lp: lp["ff_norm"]["bias"]),
        stack(lambda lp: lp["ff_w1"]["kernel"]), stack(lambda lp: lp["ff_w1"]["bias"]),
        stack(lambda lp: lp["ff_w2"]["kernel"]), stack(lambda lp: lp["ff_w2"]["bias"]),
        np.asarray(p["final_norm"]["scale"]), np.asarray(p["final_norm"]["bias"]),
        np.asarray(p["out_proj"]["kernel"]), np.asarray(p["out_proj"]["bias"]),
    ]
    rng = np.random.default_rng(11)
    B, k = x.shape[0], 8
    pos = np.stack([rng.permutation(SMALL.max_seq_len)[:k] for _ in range(B)]).astype(np.int32)
    bias = _np(rng, B, SMALL.depth, SMALL.dim, scale=0.5)
    kw = dict(local_heads=SMALL.local_heads, heads=SMALL.heads, window=SMALL.local_window)
    want = np.asarray(jax_stack(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(bias),
                                *map(jnp.asarray, arrays), **kw, interpret=True))
    got = fused_stack_logits(_t(x), _t(pos), _t(bias), *map(_t, arrays), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_proteoscribe_matches_flax(jax_model):
    model, variables, port, x, t, z = jax_model
    want = np.asarray(model.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z)))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(z)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_proteoscribe_unconditional_matches_flax(jax_model):
    _, _, _, x, t, _ = jax_model
    model = JaxProteoScribe(SMALL, conditional=False)
    variables = model.init(jax.random.key(1), jnp.asarray(x[:1]), jnp.asarray(t[:1]))
    port = proteoscribe_from_jax(variables, SMALL)
    assert not port.conditional
    want = np.asarray(model.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(_t(x), _t(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,forward", [(1, "stack"), (4, "stack"), (4, "plain")])
def test_sampler_temp0_ids_equal_jax(jax_model, k, forward):
    """Same weights, same numpy permutations, temperature 0: the port's
    sampler decodes exactly the JAX sampler's ids, on the stack forward
    (logits at the decode positions) or the plain model (full logits)."""
    model, variables, port, _, _, z = jax_model
    rng = np.random.default_rng(7)
    B, L = 2, SMALL.max_seq_len
    paths = np.stack([rng.permutation(L) for _ in range(B)]).astype(np.int32)
    jax_sample = jax_make_sampler(model.apply, SMALL.num_timesteps, temperature=0.0,
                                  positions_per_step=k)
    want = np.asarray(jax_sample(variables, jnp.asarray(z[:B]), jnp.asarray(paths),
                                 jax.random.key(0)))
    if forward == "stack":
        apply, takes_positions = make_stack_apply(port, dtype=torch.float32, gelu="erf"), True
    else:
        apply, takes_positions = port, False
    sample = make_sampler(apply, SMALL.num_timesteps, temperature=0.0, positions_per_step=k,
                          apply_takes_positions=takes_positions)
    got = sample(_t(z[:B]), _t(paths)).numpy()
    np.testing.assert_array_equal(got, want)


def test_final_head_and_time_bias_match_jax(jax_model):
    from biom3_tpu.models import fused_forward as jff

    from biom3_tpu_torch.models.fused_forward import final_head, time_bias_table

    _, variables, port, _, _, _ = jax_model
    h = _np(np.random.default_rng(9), 3, 5, SMALL.dim)
    want = np.asarray(jff.final_head(SMALL, variables["params"], jnp.asarray(h)))
    with torch.no_grad():
        np.testing.assert_allclose(final_head(port, _t(h)).numpy(), want, **TOL)
        np.testing.assert_allclose(
            time_bias_table(port).numpy(),
            np.asarray(jff.time_bias_table(SMALL, variables["params"])), **TOL)


def test_sampler_filters_and_permutations():
    from biom3_tpu.diffusion.sampler import apply_logit_filters as jax_filters
    from biom3_tpu_torch.diffusion.sampler import apply_logit_filters, sample_permutations

    rng = np.random.default_rng(8)
    lg = _np(rng, 3, 5, 29)
    for kw in (dict(top_k=4), dict(top_p=0.7), dict(top_k=6, top_p=0.5)):
        want = np.asarray(jax_filters(jnp.asarray(lg), **kw))
        got = apply_logit_filters(_t(lg), **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)])
    g = torch.Generator().manual_seed(0)
    perms = sample_permutations(g, 4, 64).numpy()
    assert perms.dtype == np.int32
    for p in perms:
        assert sorted(p) == list(range(64))


def test_sampler_temperature_draws_valid_ids(jax_model):
    """temperature > 0: ids are valid classes and the same generator seed
    reproduces the draw."""
    _, _, port, _, _, z = jax_model
    apply = make_stack_apply(port, dtype=torch.float32, gelu="erf")
    sample = make_sampler(apply, SMALL.num_timesteps, temperature=1.0, positions_per_step=8,
                          top_k=10, apply_takes_positions=True)
    paths = torch.stack([torch.randperm(SMALL.max_seq_len) for _ in range(2)]).int()
    runs = [sample(_t(z[:2]), paths, torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert bool(((runs[0] >= 0) & (runs[0] < SMALL.num_classes)).all())
