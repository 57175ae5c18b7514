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
