"""The port's ``local_window_attention`` kernel (plain version on the CPU)
against ``local_window_attention_pallas`` in interpret mode, and
``ProteoScribe(attn_impl="kernel")`` against the JAX module's
``attn_impl="pallas"``.

Tolerances: f32 atol 2e-5 (the JAX kernel tests' own, summation order
apart); bf16 atol 1e-2 on outputs of magnitude ≲ 2 (both sides round the
same unnormalised weights to bf16 and sum exactly products of bf16 values in
f32, so they differ by summation order and at most one bf16 rounding of
the output, 2^-8 relative).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biom3_tpu.config import ProteoScribeConfig
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.ops.pallas.local_attention_tpu import local_window_attention_pallas
from biom3_tpu_torch.io.from_jax import port_config, proteoscribe_from_jax
from biom3_tpu_torch.ops import kernels
from biom3_tpu_torch.ops.local_attention import local_window_attention

# (nw, W, D); W = 32 puts two windows in one 64-row warpgroup of the card's
# kernel, W = 96 a key tile across the band's edge
CASES = [(1, 64, 32), (2, 64, 64), (8, 64, 32), (2, 128, 32), (8, 128, 64), (4, 32, 32),
         (3, 96, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nw,window,D", CASES)
def test_local_window_attention_matches_pallas(nw, window, D, dtype):
    rng = np.random.default_rng(nw * 1000 + window + D)
    q, k, v = (rng.standard_normal((2, 2, nw * window, D)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(local_window_attention_pallas(jq, jk, jv, window=window)
                          .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got = local_window_attention(tq, tk, tv, window=window, impl="kernel")
    assert got.dtype == tv.dtype and got.shape == tv.shape
    atol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_kernel_rounding_points_differ_from_plain_form():
    """In bf16 the kernel's points (unnormalised e rounded, divide after)
    are not the plain lucidrains form's (normalised p rounded): the two
    must not be one function under two names."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, 32)).astype(np.float32))
               .bfloat16() for _ in range(3))
    a = local_window_attention(q, k, v, window=64, impl="kernel")
    b = local_window_attention(q, k, v, window=64, impl="plain")
    assert not torch.equal(a, b)
    assert float((a.float() - b.float()).abs().max()) < 5e-2


def test_local_window_attention_is_forward_only():
    q = torch.randn(1, 2, 64, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        local_window_attention(q, q, q, window=32, impl="kernel")
    with torch.no_grad():
        assert local_window_attention(q, q, q, window=32, impl="kernel").shape == q.shape
    with pytest.raises(ValueError, match="impl"):
        local_window_attention(q, q, q, window=32, impl="pallas")
    kernels.reset_launches()
    with torch.no_grad():
        kernels.local_window_attention(q.detach(), q.detach(), q.detach(), window=32)
    assert kernels.launch_counts()["local_window_attention"] == 0   # the CPU runs the plain form


def test_proteoscribe_kernel_attn_matches_jax_pallas():
    cfg = ProteoScribeConfig(num_classes=29, dim=64, depth=2, n_blocks=1, heads=4,
                             local_heads=2, local_window=32, max_seq_len=128,
                             num_timesteps=128, cond_dim=16)
    rng = np.random.default_rng(1)
    B, L = 2, cfg.max_seq_len
    variables = JaxProteoScribe(cfg).init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16)))
    variables = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), variables)
    x = rng.integers(0, 29, (B, L)).astype(np.int32)
    t = rng.integers(0, L, (B,)).astype(np.int32)
    z = rng.standard_normal((B, 16)).astype(np.float32)
    # one jitted computation: run eagerly, the interpret-mode kernel's host
    # callbacks dispatch JAX ops while the model's own eager ops are being
    # dispatched, which can deadlock the CPU client
    apply = jax.jit(JaxProteoScribe(cfg, attn_impl="pallas").apply)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z)))
    port = proteoscribe_from_jax(variables, port_config(cfg))
    kernel = type(port)(port.config, attn_impl="kernel")
    kernel.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = kernel.eval()(*map(torch.from_numpy, (x, t, z))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
