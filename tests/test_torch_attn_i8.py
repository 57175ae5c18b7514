"""The int8 band-local attention in biom3_tpu_torch against the JAX package (CPU, f32).

``ops/kernels.stage3_attention_core_i8_plain`` (the plain version of
``csrc/stage3_attn_i8.cu``, and what the wrapper runs on a CPU tensor)
against the body the TPU kernel runs, ``_attn_core_t(...,
attn_quant="int8")`` (stack_kernel_tpu.py:112-180), called as jnp on the
CPU with identity projections so that it sees the same q, k and v rows.
The q, k and v codes and scales equal the JAX recipe's (its lines
:129-138 written out below: the codes live inside ``_attn_core_t``) bit
for bit; the outputs agree within atol 1e-5 (f32 softmax sums and
dequant products rounded in another order; one p or v code step would move
an output by ~1e-2).  The whole stack forward with
``attn_quant="int8"`` agrees with JAX ``make_stack_apply(..., resident=True,
stream="dl", interpret=True, attn_quant="int8")`` within atol 5e-4, rtol
1e-3: a q, k or v code at a rounding boundary may move by one step when
the f32 inputs differ by ~1e-6 in the last bits, which moves a logit by
~1e-4, against ~2e-3 for the int8 products themselves; and both stay
within the JAX test's 0.999 cosine of the f32 Flax graph
(tests/test_stack_kernel.py:181-203).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import ProteoScribeConfig
from biom3_tpu.models.fused_forward import make_stack_apply as jax_make_stack_apply
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.ops.pallas.stack_kernel_tpu import _attn_core_t
from biom3_tpu_torch.io.from_jax import port_config, proteoscribe_from_jax
from biom3_tpu_torch.models.fused_forward import make_stack_apply
from biom3_tpu_torch.ops import kernels as K

SMALL = ProteoScribeConfig(
    num_classes=29, dim=64, depth=3, n_blocks=1, heads=4, local_heads=2,
    local_window=32, max_seq_len=128, num_timesteps=128, cond_dim=48,
)


def _jax_codes(x, axis):
    """stack_kernel_tpu.py:129-138: per-slice amax, round half to even."""
    xf = x.astype(jnp.float32)
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis, keepdims=True), 1e-6)
    q = jnp.clip(jnp.round(xf * (127.0 / amax)), -127.0, 127.0).astype(jnp.int8)
    return np.asarray(q), np.asarray(amax * (1.0 / 127.0))


@pytest.mark.parametrize("L,heads,local,dh,window", [(64, 4, 2, 8, 16), (96, 3, 3, 16, 32),
                                                     (128, 2, 1, 32, 128)])
def test_plain_twin_equals_jax_attn_core(L, heads, local, dh, window):
    """One sequence, ``_attn_core_t`` on [q; k; v] through identity
    projections (HIGHEST precision: exact) against the plain twin: the
    band heads' output, the linear heads' and every code and scale."""
    rng = np.random.default_rng(L + heads)
    d = heads * dh
    qkv = (rng.standard_normal((L, 3 * d)) * rng.uniform(0.2, 3.0, 3 * d)).astype(np.float32)
    eye, zero = np.eye(d, dtype=np.float32), np.zeros((d, d), np.float32)
    w = [np.concatenate(blocks, 1) for blocks in ((eye, zero, zero), (zero, eye, zero),
                                                   (zero, zero, eye))]
    want = np.asarray(_attn_core_t(
        jnp.asarray(qkv.T), *map(jnp.asarray, w), None, None, None, nl=local,
        ng=heads - local, Dh=dh, W=window, nw=L // window, L=L, scale=dh ** -0.5,
        precision=jax.lax.Precision.HIGHEST, cdtype=jnp.float32, proj_quant="none",
        attn_quant="int8")).T
    got, (q8, sq, k8, sk, v8, sv) = K.stage3_attention_core_i8(
        torch.from_numpy(qkv[None]), heads=heads, local_heads=local, window=window, codes=True)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)

    heads_of = lambda part: qkv[:, part * d:part * d + local * dh].reshape(L, local, dh)
    for (codes, scale), axis, x in (((q8, sq), -1, heads_of(0)), ((k8, sk), -1, heads_of(1))):
        jq, js = _jax_codes(jnp.asarray(x.transpose(1, 0, 2)), axis)   # (local, L, Dh)
        np.testing.assert_array_equal(codes[0].numpy(), jq)
        np.testing.assert_array_equal(scale[0].numpy(), js[..., 0])
    jq, js = _jax_codes(jnp.asarray(heads_of(2).transpose(1, 2, 0)), 2)  # (local, Dh, L) over L
    np.testing.assert_array_equal(v8[0].numpy(), jq)
    np.testing.assert_array_equal(sv[0].numpy(), js[..., 0])


def test_wrapper_checks_and_layouts():
    """The CPU wrapper runs the plain twin; codes come in the kernel's
    layouts; its PV sums stay exact past 2^24, as the kernel's int32 ones;
    a bad ``attn_quant`` is refused at the stack forward's call."""
    qkv = torch.randn(2, 32, 3 * 16)
    out, codes = K.stage3_attention_core_i8(qkv, heads=2, local_heads=1, window=8, codes=True)
    assert out.shape == (2, 32, 16)
    assert [tuple(c.shape) for c in codes] == [(2, 1, 32, 8), (2, 1, 32), (2, 1, 32, 8),
                                               (2, 1, 32), (2, 1, 8, 32), (2, 1, 8)]
    assert [c.dtype for c in codes] == [torch.int8, torch.float32] * 3
    assert torch.equal(out, K.stage3_attention_core_i8_plain(qkv, heads=2, local_heads=1,
                                                             window=8))
    # no band head: the linear heads alone, equal to the bf16 core's plain version
    assert torch.equal(K.stage3_attention_core_i8(qkv, heads=2, local_heads=0, window=8),
                       K.stage3_attention_core_plain(qkv, heads=2, local_heads=0, window=8))
    # a window of 800 with q = 0: every valid key gets p = pamax, so pq =
    # 127, and v > 0 gives v codes of 64..127; the sums over 1600 and 2400
    # keys pass 2^24, where an f32 sum of codes rounds
    L, W, dh = 2400, 800, 32
    qkv = torch.zeros(1, L, 3 * dh)
    qkv[..., 2 * dh:] = torch.from_numpy(
        np.random.default_rng(7).uniform(0.5, 1.0, (L, dh)).astype(np.float32))
    out, (_, _, _, _, v8, sv) = K.stage3_attention_core_i8(qkv, heads=1, local_heads=1,
                                                           window=W, codes=True)
    keys = np.array([2 * W, 3 * W, 2 * W]).repeat(W)              # each row's band
    lo = np.array([0, 0, W]).repeat(W)
    codes = v8[0, 0].numpy().astype(np.int64)                     # (Dh, L)
    acc = np.stack([127 * codes[:, a:a + n].sum(1) for a, n in zip(lo, keys)])
    assert acc.max() > 2 ** 24
    pamax = 1.0 / torch.from_numpy(keys).float()[:, None]         # p = 1 / keys, exactly
    want = torch.from_numpy(acc).float() * sv[0, 0] * (pamax * (1.0 / 127.0))
    assert torch.equal(out[0], want)
    port = proteoscribe_from_jax(*_tiny_model()[1:3])
    apply = make_stack_apply(port, dtype=torch.float32, attn_quant="fp8")
    B, T = 1, SMALL.max_seq_len
    with pytest.raises(ValueError, match="attn_quant must be 'none' or 'int8', got 'fp8'"):
        apply(torch.zeros(B, T, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
              torch.zeros(B, SMALL.cond_dim), torch.zeros(B, 1, dtype=torch.int32))


def _tiny_model():
    model = JaxProteoScribe(SMALL)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 29, (2, SMALL.max_seq_len)).astype(np.int32)
    variables = model.init(jax.random.key(0), jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, SMALL.cond_dim)))
    return model, variables, port_config(SMALL)


def test_stack_apply_int8_equals_jax_stack_kernel():
    """The stack forward with ``attn_quant="int8"`` (f32, erf GELU) against
    the TPU kernel's int8 branch in interpret mode, and both against the f32
    Flax graph at the JAX test's 0.999 cosine gate."""
    model, variables, cfg = _tiny_model()
    rng = np.random.default_rng(1)
    B, L = 2, SMALL.max_seq_len
    x = rng.integers(0, 29, (B, L)).astype(np.int32)
    t = rng.integers(0, SMALL.num_timesteps, (B,)).astype(np.int32)
    z = rng.standard_normal((B, SMALL.cond_dim)).astype(np.float32)
    pos = np.stack([rng.permutation(L)[:4] for _ in range(B)]).astype(np.int32)
    jx = [jnp.asarray(a) for a in (x, t, z, pos)]
    want = np.asarray(jax_make_stack_apply(SMALL, dtype=jnp.float32, resident=True, stream="dl",
                                           interpret=True, attn_quant="int8")(variables, *jx))
    ref = np.asarray(jnp.take_along_axis(model.apply(variables, *jx[:3]), jx[3][..., None],
                                         axis=1))
    port = proteoscribe_from_jax(variables, cfg)
    got = make_stack_apply(port, dtype=torch.float32, gelu="erf", attn_quant="int8")(
        *map(torch.from_numpy, (x, t, z, pos))).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    for out in (got, want):
        a, b = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() >= 0.999, cos.min()


# --------------------------------------------------------------------------
# the band kernel's plans (csrc/stage3_attn_i8.cu), as index arithmetic
# --------------------------------------------------------------------------

def _acc_cell(warp, lane, reg):
    """wgmma m64nN s32 accumulator: register 4q + 2h + e of ``lane`` in
    ``warp`` → (row, column) (PTX ISA, the D fragment of wgmma .m64nNk*)."""
    q, h, e = reg // 4, (reg // 2) % 2, reg % 2
    return 16 * warp + lane // 4 + 8 * h, 8 * q + 2 * (lane % 4) + e


def _a_cell(warp, lane, reg, byte):
    """wgmma k32 s8 register A fragment: byte ``byte`` of register ``reg``
    → (row, k) (PTX ISA, the A fragment of wgmma .m64nNk32 with .s8)."""
    return 16 * warp + lane // 4 + 8 * (reg % 2), 4 * (lane % 4) + byte + 16 * (reg // 2)


def test_pv_order_is_the_accumulator_to_fragment_permutation():
    """The kernel packs a thread's S codes of q = 0, 1 (one row) into one A
    register and q = 2, 3 into the next: at every (row, k) of the fragment
    that puts the code of key ``stage3_i8_pv_order()[k]``, checked cell by
    cell over a warpgroup's 128 threads, and P·V on v8 in that order equals
    P·V on v8 in key order."""
    order = K.stage3_i8_pv_order()
    assert sorted(order) == list(range(32))
    S = np.arange(64 * 32).reshape(64, 32)          # any distinct values a (row, key)
    A = np.full((64, 32), -1)
    for warp in range(4):
        for lane in range(32):
            held = {}
            for reg in range(16):                   # the four q of one 32-key group
                row, col = _acc_cell(warp, lane, reg)
                held[reg] = S[row, col]
            for half in range(2):
                for h in range(2):
                    codes = [held[4 * (2 * half + qq) + 2 * h + e]
                             for qq in range(2) for e in range(2)]
                    for byte, code in enumerate(codes):
                        A[_a_cell(warp, lane, 2 * half + h, byte)] = code
    np.testing.assert_array_equal(A, S[:, order])
    rng = np.random.default_rng(0)
    p, v = rng.integers(0, 128, (64, 32)), rng.integers(-127, 128, (32, 8))
    np.testing.assert_array_equal(p[:, order] @ v[order], p @ v)


@pytest.mark.parametrize("L,pairs", [(1024, 32), (1024, 256), (1024, 16), (1024, 8),
                                     (200, 6), (1000, 16), (128, 1), (4096, 4)])
def test_quant_plan_fills_the_card_and_covers_every_row(L, pairs):
    """Chunks of whole 128-row slices that cover the sequence once, the
    fewest that give about two blocks an SM: at least a wave at Stage-3
    B=4 (32 pairs), two chunks at B=32."""
    rows = K.stage3_i8_quant_plan(L, pairs, 132)
    chunks = -(-L // rows)
    assert rows % 128 == 0 and (chunks - 1) * rows < L <= chunks * rows
    assert chunks <= -(-L // 128)
    if chunks < -(-L // 128):
        assert chunks * pairs >= 2 * 132
        assert (chunks - 1) * pairs < 2 * 132 or -(-L // (chunks - 1)) > rows
    if (L, pairs) == (1024, 32):
        assert (chunks, chunks * pairs) == (8, 256)
    if (L, pairs) == (1024, 256):
        assert (rows, chunks) == (512, 2)


@pytest.mark.parametrize("L,window", [(1024, 128), (512, 32), (256, 8), (1000, 40), (200, 40),
                                      (512, 64), (96, 96), (2400, 800)])
def test_band_tiles_cover_each_rows_band(L, window):
    """Every 128-query block's staged tiles start on a 32-key group and
    hold the band (windows w-1..w+1 inside [0, L)) of each of its rows,
    with no tile past the last key any row needs."""
    plan = K.stage3_i8_band_tiles(L, window)
    assert len(plan) == -(-L // 128)
    for blk, (kt0, tiles) in enumerate(plan):
        assert kt0 >= 0 and kt0 % 32 == 0 and tiles >= 1
        rows = range(blk * 128, min(L, blk * 128 + 128))
        lo = min(max(0, (r // window - 1) * window) for r in rows)
        hi = max(min(L, (r // window + 2) * window) for r in rows)
        assert kt0 <= lo and kt0 > lo - 32 and hi <= kt0 + 128 * tiles
        assert kt0 + 128 * (tiles - 1) < hi
    if (L, window) == (1024, 128):   # the Stage-3 band: three tiles, none wasted
        assert plan[1:-1] == [(128 * (i - 1), 3) for i in range(1, 7)]
    # each warpgroup's 64-key half tiles: every key of its rows' bands,
    # none outside them all; the mask-free ones inside every row's band
    halves = iter(K.stage3_i8_half_tiles(L, window))
    for blk, (kt0, tiles) in enumerate(plan):
        for row0 in range(blk * 128, min(L, blk * 128 + 128), 64):
            computed = next(halves)
            rows = range(row0, min(L, row0 + 64))
            bands = [set(range(max(0, (r // window - 1) * window),
                               min(L, (r // window + 2) * window))) for r in rows]
            keys = set().union(*(range(k0, k0 + 64) for k0, _ in computed))
            assert set.union(*bands) <= keys
            for k0, whole in computed:
                assert kt0 <= k0 < kt0 + 128 * tiles and (k0 - kt0) % 64 == 0
                half = set(range(k0, k0 + 64))
                assert half & set.union(*bands)
                assert whole == all(half <= band for band in bands)
            if window % 128 == 0:   # the Stage-3 bands need no mask
                assert all(whole for _, whole in computed)
    assert next(halves, None) is None
    for dh in (32, 64):
        fits = K.stage3_i8_band_smem(L, window, dh) <= K.I8_MAX_SMEM
        assert fits == (dh == 32 or (L, window) != (2400, 800))   # 19 tiles at Dh 64 do not


# the shapes chip_smoke.py phase 3 checks the kernel at: (B, L, heads,
# local heads, W) at d = 512, then d = 256
EDGE = [(4, 1024, 16, 8, 128, 512), (2, 512, 8, 4, 128, 512), (2, 512, 16, 8, 32, 512),
        (2, 256, 16, 8, 8, 512), (2, 1024, 16, 16, 128, 512), (2, 1000, 16, 8, 40, 512),
        (3, 200, 4, 2, 40, 256)]


@pytest.mark.parametrize("B,L,heads,local,window,d", EDGE)
def test_kernel_rounding_moves_p_codes_by_one_step(B, L, heads, local, window, d):
    """The band kernel rounds p as rint(127 · exp2(fma(x, c, −m))) from the
    row max alone; the TPU kernel as rint(p · (127 / max p)) after the
    softmax.  On seeded qkv at phase 3's shapes, from the same codes: each
    p code moves by at most one step, few move, and the output moves by
    under chip_smoke.py's REL_TOL (2e-2) per head."""
    rng = np.random.default_rng(L + window + d)
    qkv = torch.from_numpy(rng.standard_normal((B, L, 3 * d)).astype(np.float32))
    dh = d // heads
    q, k, v = (t.reshape(B, L, heads, dh).transpose(1, 2)[:, :local]
               for t in qkv.split(d, dim=-1))
    q8, sq = K._i8_codes(q, -1)
    k8, sk = K._i8_codes(k, -1)
    v8, sv = K._i8_codes(v.transpose(-1, -2), -1)
    o_plain, pq_plain = K.stage3_i8_band_plain(q8, sq, k8, sk, v8, sv, window=window)
    o_kern, pq_kern = K.stage3_i8_band_plain(q8, sq, k8, sk, v8, sv, window=window,
                                             rounding="kernel")
    step = (pq_kern.int() - pq_plain.int()).abs()
    assert int(step.max()) <= 1
    assert int((step > 0).sum()) <= 1e-3 * int((pq_plain > 0).sum()) + 1
    rel = ((o_kern - o_plain).abs().amax((0, 2, 3))
           / o_plain.abs().amax((0, 2, 3)).clamp(min=1e-30))
    assert float(rel.max()) < 2e-2
    # and the plain rounding is the plain version's own
    out = K.stage3_attention_core_i8_plain(qkv, heads=heads, local_heads=local, window=window)
    got = out.reshape(B, L, heads, dh)[:, :, :local].transpose(1, 2)
    assert torch.equal(got, o_plain)


def test_pq_codes_need_the_card():
    qkv = torch.randn(1, 32, 3 * 16)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        K.stage3_attention_core_i8(qkv, heads=2, local_heads=1, window=8, pq=True)
    with pytest.raises(ValueError, match="rounding must be"):
        K.stage3_i8_band_plain(*K._i8_codes(qkv[..., :8].reshape(1, 1, 32, 8), -1),
                               *K._i8_codes(qkv[..., 16:24].reshape(1, 1, 32, 8), -1),
                               *K._i8_codes(qkv[..., 32:40].reshape(1, 1, 8, 32), -1),
                               window=8, rounding="bf16")
