"""The port's row-wise ``layernorm`` (its plain version on the CPU) against
the JAX package's f32 LayerNorm (``fused_layer_tpu._layernorm``, the
two-pass parity form) at the widths its callers use: the Stage-3 FF
pre-norm (d 512, eps 1e-6), BERT's post-norms (768, 1e-12), ESM2's norms
(1280, 1e-5), a ragged 264 (off the kernel's 256-column stride), and
ESM2-3B's 2560 (past the columns the kernel holds in registers).

Inputs are f32 or bf16-rounded values (ESM2's LN1 reads the bf16
residual), passed in f32: on the CPU the wrapper computes in f32.
Tolerance atol 1e-5 on outputs of magnitude ≲ 5: both are two-pass f32
LayerNorms and differ by summation order only.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.ops.pallas.fused_layer_tpu import _layernorm
from biom3_tpu_torch.ops import kernels as K

WIDTHS = [(512, 1e-6), (768, 1e-12), (1280, 1e-5), (264, 1e-5), (2560, 1e-5)]   # (d, eps)


@pytest.mark.parametrize("want_f32", [False, True])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,eps", WIDTHS)
def test_layernorm_plain_matches_jax(d, eps, in_dtype, want_f32):
    rng = np.random.default_rng(d)
    x = (3.0 * rng.standard_normal((37, d)) + 0.5).astype(np.float32)
    if in_dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(d)).astype(np.float32)
    want = np.asarray(_layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), eps=eps))
    K.reset_launches()
    got = K.layernorm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift),
                      eps=eps, out_dtype=torch.float32, want_f32=want_f32)
    assert K.launch_counts()["layernorm"] == 0   # the CPU runs the plain version
    outs = got if want_f32 else (got,)
    assert len(outs) == (2 if want_f32 else 1)
    for y in outs:
        assert y.dtype == torch.float32 and y.shape == (37, d)
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [512, 1280, 1288, 2560])
def test_bias_layernorm_plain_matches_jax(d):
    """``bias_layernorm`` (its plain version on the CPU) against the JAX
    package's f32 LayerNorm of h + bias (``fused_layer_tpu._layernorm``,
    eps 1e-6) at the widths of the kernel's routes: Stage 3's 512, 1280
    (the widest row held in registers), a ragged 1288 and 2560 (staged in
    shared memory).  h in bf16-rounded values, as the card gives it; 37
    rows a batch row, so a bias row spans rows off the 8-row blocks.  xb
    is the f32 sum exactly; xn atol 1e-5 (summation order only)."""
    rng = np.random.default_rng(d + 1)
    h = torch.from_numpy((3.0 * rng.standard_normal((2, 37, d)) + 0.5).astype(np.float32))
    h = h.bfloat16().float()
    bias = torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32)).bfloat16().float()
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(d)).astype(np.float32)
    xsum = h.numpy() + bias.numpy()[:, None, :]
    want = np.asarray(_layernorm(jnp.asarray(xsum), jnp.asarray(scale), jnp.asarray(shift),
                                 eps=1e-6))
    K.reset_launches()
    xb, xn = K.bias_layernorm(h, bias, torch.from_numpy(scale), torch.from_numpy(shift))
    assert K.launch_counts()["bias_layernorm"] == 0   # the CPU runs the plain version
    assert xb.dtype == xn.dtype == torch.float32 and xb.shape == xn.shape == (2, 37, d)
    np.testing.assert_array_equal(xb.numpy(), xsum)
    np.testing.assert_allclose(xn.numpy(), want, atol=1e-5, rtol=0)
