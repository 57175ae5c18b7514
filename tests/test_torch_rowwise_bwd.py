"""The training backward's row-wise reductions of the port, on the CPU
(their plain versions), against the JAX package in f32.

* ``layernorm_bwd`` against ``_ln_bwd`` of the TPU training kernels
  (``layer_block_tpu.py:58-68``, x̂ and rstd from its ``_ln_fwd``), with
  and without the residual the caller adds, at the widths the layer blocks
  use (Stage 3's 512, ESM2-650M's 1280) and past the 1280 columns the
  kernel holds in registers: a ragged 1288, ESM2-3B's 2560 and a Stage-3
  dim of 4096 (the kernel's shared-memory route);
* ``col_sum`` against ``jnp.sum(axis=0)`` at the bias gradients' widths
  (ESM2-3B's FF 10240 among them) and at 8 columns;
* ``col_sum_plan``, the kernel's grid rule: every row in exactly one slab.

Inputs come from numpy with a seed.  Tolerance ``PLAIN_TOL`` (atol 1e-5,
rtol 1e-4): f32 on both sides, the same arithmetic in other orders.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.ops.pallas.layer_block_tpu import _ln_bwd, _ln_fwd
from biom3_tpu_torch.ops import kernels as K

PLAIN_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("d,eps", [(512, 1e-6), (1280, 1e-5), (1288, 1e-5), (2560, 1e-5),
                                   (4096, 1e-6)])
def test_layernorm_bwd_plain_matches_jax_ln_bwd(d, eps, residual):
    rng = np.random.default_rng(d + residual)
    rows = 19
    x = (2.0 * rng.standard_normal((rows, d)) + 0.3).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    res = rng.standard_normal((rows, d)).astype(np.float32) if residual else None
    _, xhat, rstd = _ln_fwd(jnp.asarray(x), jnp.asarray(gamma), jnp.zeros(d), eps=eps)
    want_dx, want_dg, want_db = (np.asarray(t) for t in _ln_bwd(jnp.asarray(dy), xhat, rstd,
                                                                  jnp.asarray(gamma)))
    if residual:
        want_dx = want_dx + res
    K.reset_launches()
    dx, dg, db = K.layernorm_bwd(torch.from_numpy(x), torch.from_numpy(dy),
                                 torch.from_numpy(gamma),
                                 residual=None if res is None else torch.from_numpy(res),
                                 eps=eps, out_dtype=torch.float32)
    assert K.launch_counts()["layernorm_bwd"] == 0   # the CPU runs the plain version
    assert dx.shape == (rows, d) and dg.shape == db.shape == (d,)
    np.testing.assert_allclose(dx.numpy(), want_dx, **PLAIN_TOL)
    np.testing.assert_allclose(dg.numpy(), want_dg[0], **PLAIN_TOL)
    np.testing.assert_allclose(db.numpy(), want_db[0], **PLAIN_TOL)


@pytest.mark.parametrize("rows,n", [(64, 10240), (1000, 512), (7, 264), (130, 8)])
def test_col_sum_plain_matches_jnp_sum(rows, n):
    x = np.random.default_rng(n).standard_normal((rows, n)).astype(np.float32)
    K.reset_launches()
    got = K.col_sum(torch.from_numpy(x))
    assert K.launch_counts()["col_sum"] == 0
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.sum(jnp.asarray(x), axis=0)),
                               **PLAIN_TOL)


@pytest.mark.parametrize("rows,n,capacity", [
    (4096, 512, 528), (32768, 512, 528), (32768, 2048, 528), (4096, 1280, 528),
    (4096, 5120, 528), (16384, 10240, 528), (4161, 512, 528), (1, 8, 528), (7, 264, 528),
    (0, 16, 528), (130, 8, 114), (8191, 300000, 528),
])
def test_col_sum_plan_covers_every_row_once(rows, n, capacity):
    slabs, per = K.col_sum_plan(rows, n, capacity)
    tiles = -(-n // K.COL_SUM_TILE)
    assert slabs >= 1 and per >= 1
    assert (slabs - 1) * per < max(rows, 1) <= slabs * per   # no empty slab, every row in one
    assert slabs == 1 or (tiles * slabs <= capacity and tiles <= K.COL_SUM_MAX_TILES
                          and per >= K.COL_SUM_MIN_ROWS)
