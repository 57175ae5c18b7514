"""The Stage-3 attention core of the port against the JAX package (CPU, f32).

* ``ops/stage3_layer.fused_attn_half`` — and through it
  ``kernels.stage3_attention_core`` on its plain version — against JAX
  ``fused_attn_half(..., interpret=True)`` at the card kernel's head dims
  32 and 64 (d = 128 with 4 and 2 heads), with no, half and all heads
  band-local, windows 16 and 32, L = 4 windows.  Tolerance atol 2e-4 /
  rtol 1e-3, as ``tests/test_torch_stage3.py``: f32 on both sides,
  different summation orders.
* ``stage3_linear_plan``, the linear heads' sequence split on the card,
  and ``stage3_linear_bwd_plan``, their backward's: every row in exactly
  one chunk, none empty.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.ops.pallas.fused_layer_tpu import fused_attn_half as jax_fused_attn_half
from biom3_tpu_torch.ops import kernels as K
from biom3_tpu_torch.ops.stage3_layer import fused_attn_half

TOL = dict(atol=2e-4, rtol=1e-3)
D = 128
LIN_BWD_MAX_PAIRS = 8192   # csrc/stage3_attn_bwd.cu's LIN_MAX_PAIRS (its tickets)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("window", [16, 32])
@pytest.mark.parametrize("heads,local_heads", [(4, 0), (4, 2), (4, 4), (2, 0), (2, 1), (2, 2)])
def test_fused_attn_half_matches_jax(heads, local_heads, window):
    rng = np.random.default_rng(heads * 100 + local_heads * 10 + window)
    B, L = 2, 4 * window
    args = [_np(rng, B, L, D), _np(rng, B, D), 1 + _np(rng, D, scale=0.1), _np(rng, D, scale=0.1)]
    args += [_np(rng, D, D, scale=D ** -0.5) for _ in range(4)] + [_np(rng, D, scale=0.1)]
    kw = dict(local_heads=local_heads, heads=heads, window=window)
    want = np.asarray(jax_fused_attn_half(*map(jnp.asarray, args), **kw, interpret=True))
    got = fused_attn_half(*(torch.from_numpy(a) for a in args), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads,local_heads", [(4, 2), (2, 0), (2, 2)])
def test_stage3_attention_core_on_cpu_is_its_plain_version(heads, local_heads):
    qkv = torch.from_numpy(_np(np.random.default_rng(heads + local_heads), 2, 64, 3 * D))
    kw = dict(heads=heads, local_heads=local_heads, window=16)
    assert torch.equal(K.stage3_attention_core(qkv, **kw), K.stage3_attention_core_plain(qkv, **kw))


@pytest.mark.parametrize("L,pairs,sms", [(1024, 16, 132), (1024, 32, 132), (1024, 64, 132),
                                         (1024, 256, 132), (1000, 16, 132), (64, 16, 132),
                                         (200, 3, 132), (1024, 10000, 132), (8, 1, 132),
                                         (4096, 8, 78)])
def test_stage3_linear_plan_covers_every_row_once(L, pairs, sms):
    chunks, per, srows, lrows = K.stage3_linear_plan(L, pairs, sms)
    # ctx's chunks, then the statistics' and the output rows' blocks (the
    # kernels launch ceil(L / srows) and ceil(L / lrows) of them a pair)
    for n, size in ((chunks, per), (-(-L // srows), srows), (-(-L // lrows), lrows)):
        covered = np.zeros(L, dtype=int)
        for c in range(n):
            rows = range(c * size, min(L, (c + 1) * size))
            assert len(rows) > 0
            covered[list(rows)] += 1
        assert (covered == 1).all()
    assert chunks == 1 or per >= K.LIN_MIN_ROWS
    assert chunks * pairs <= max(2 * sms, pairs)   # about two blocks an SM, or one chunk a pair
    assert srows % K.LIN_MIN_ROWS == 0 and srows <= 4 * K.LIN_MIN_ROWS
    assert lrows % K.LIN_OUT_ROWS == 0 and lrows <= 4 * K.LIN_OUT_ROWS


@pytest.mark.parametrize("L,pairs,sms", [(1024, 16, 132), (1024, 32, 132), (1024, 256, 132),
                                         (1000, 16, 132), (64, 16, 132), (200, 3, 132),
                                         (1024, 10000, 132), (8, 1, 132), (4096, 8, 78),
                                         (1024, 2048, 132)])
def test_stage3_linear_bwd_plan_covers_every_row_once(L, pairs, sms):
    """The linear heads' backward chunks (``lin_bwd1..3`` launch ceil(L /
    chunk) of them a pair): every row in exactly one, none empty; more than
    one only within the kernel's ticket count; about the blocks an SM the
    rule allows, unless the chunks are already the least."""
    chunk = K.stage3_linear_bwd_plan(L, pairs, sms, LIN_BWD_MAX_PAIRS)
    n = -(-L // chunk)
    covered = np.zeros(L, dtype=int)
    for c in range(n):
        rows = range(c * chunk, min(L, (c + 1) * chunk))
        assert len(rows) > 0
        covered[list(rows)] += 1
    assert (covered == 1).all()
    assert n == 1 or pairs <= LIN_BWD_MAX_PAIRS
    assert chunk == L or chunk % K.LIN_BWD_MIN_ROWS == 0
    assert (n * pairs <= K.LIN_BWD_BLOCKS_PER_SM * sms or n == 1
            or chunk == K.LIN_BWD_MIN_ROWS)
