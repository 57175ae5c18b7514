"""ESM2 layer with a hand-written backward, for Stage-1 training.

Counterpart of ``biom3_tpu/ops/pallas/esm2_block_tpu.py`` (``esm2_attn_block``
:491, ``ff_residual_block`` :611, ``esm2_layer_block`` :637): the fair-esm
``TransformerLayer`` as two autograd Functions, each saving only its input
and recomputing in the backward, as the TPU kernels do:

  xa = x + OutProj(Attn(rot(q), rot(k), v)) + bo,  [q|k|v] = LN1(x)·W3 + b3
  y  = xa + W2·gelu(W1·LN2(xa) + b1) + b2

* Attention half, forward (``_attn_fwd_kernel`` :118-144): ``layernorm``
  (eps 1e-5) → q/k/v ``gemm_bias_act`` with b3 → ``esm2_attention``
  (GPT-NeoX rotary over the full head dim, PAD keys at -1e9) → out-projection
  ``gemm_bias_act`` with bo and the residual x, xa in the compute dtype.
  Backward (:147-283): dWo = attnᵀ·dy, dbo = Σ dy, dattn = dy·Woᵀ,
  ``esm2_attention_bwd`` (dqkv in the compute dtype, the TPU's bf16 staging
  at full width), dxn = dqkv·W3ᵀ in f32, dW3 = xnᵀ·dqkv, db3 = Σ dqkv, and
  ``layernorm_bwd`` of LN1 adds dy: dx = dy + dx_ln.
* FF half, forward (``_ff_fwd_kernel`` :286-312): ``layernorm`` → W1
  ``gemm_bias_act`` with b1 and GELU → W2 ``gemm_bias_act`` with b2 and the
  residual.  Backward (:315-377): the W1 product recomputed with its f32
  pre-activation h1; dW2 = gᵀ·dy, db2; dh1 = (dy·W2ᵀ)∘gelu'(h1) in the GEMM's
  epilogue; dW1, db1; du = dh1·W1ᵀ in f32; ``layernorm_bwd`` of LN2 adds dy.

The TPU kernels sum the weight gradients over a sequential batch grid; here
each weight gradient is one ``gemm_dw`` (or ``col_sum``) over all B·L rows,
in f32.  The weights come in as the f32 master parameters in the (d_in,
d_out) layout — w3 stacked (3, E, E) as the JAX signature has it — and are
cast inside; their gradients leave in f32 in the same layouts, so autograd
hands each ``nn.Linear`` weight its (d_out, d_in) gradient.  The PAD mask is
(B, L), True (nonzero) at PAD keys: the TPU kernel's ``padneg`` is
-1e9 × this mask.  ESM2 has no dropout, nor does this block.

Under tp (``esm2_layer_block(..., tp=)``, ``parallel/tensor.py``) each
half runs Megatron on the rank's shards: q/k/v and W1 on its column
shards, the attention on its ``heads/tp`` heads (rotary is per head), the
out-projection and W2 on its row shards; the partial outputs are summed
over tp in f32, rank 0's with the bias and the residual, then cast, and
in the backward the partial dxn and du are summed over tp in f32 before
their ``layernorm_bwd``.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import (
    col_sum,
    esm2_attention,
    esm2_attention_bwd,
    gemm_bias_act,
    gemm_dw,
    gemm_dx,
    layernorm,
    layernorm_bwd,
)
from biom3_tpu_torch.ops.rotary import rotary_cos_sin
from biom3_tpu_torch.parallel.tensor import all_reduce_, row_parallel, scatter_to_tp

LN_EPS = 1e-5  # fair-esm LayerNorm eps (esm2_block_tpu.py:52)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _attn_forward(x2, pad, w3, b3, cos, sin, ls1, lb1, B, L, heads):
    """→ (xn, qkv, attn) of the attention half; x2 (B·L, E), w3 (E, 3·E')
    with E' = E or, under tp, the rank's heads' columns."""
    El = w3.shape[1] // 3
    xn = layernorm(x2, ls1, lb1, eps=LN_EPS, out_dtype=x2.dtype)
    qkv = gemm_bias_act(xn, w3, b3).view(B, L, 3 * El)
    att = esm2_attention(qkv, pad, cos, sin, heads=heads).view(B * L, El)
    return xn, qkv, att


class Esm2AttnBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad, w3, b3, wo, bo, ls1, lb1, heads, tp):
        B, L, E = x.shape
        El = w3.shape[2]
        cd = x.dtype
        cos, sin = rotary_cos_sin(L, El // heads, dtype=cd, device=x.device)
        x2 = x.reshape(B * L, E)
        w3c = torch.cat(w3.unbind(0), dim=1).to(cd)
        *_, att = _attn_forward(x2, pad, w3c, _f32(b3.reshape(3 * El)), cos, sin, _f32(ls1),
                                _f32(lb1), B, L, heads)
        xa = row_parallel(att, wo.to(cd).contiguous(), _f32(bo), x2, tp, cd)
        ctx.save_for_backward(x, pad, w3, b3, wo, ls1, lb1)
        ctx.heads, ctx.tp = heads, tp
        return xa.view(B, L, E)

    @staticmethod
    def backward(ctx, dy):
        x, pad, w3, b3, wo, ls1, lb1 = ctx.saved_tensors
        heads, tp = ctx.heads, ctx.tp
        B, L, E = x.shape
        El = w3.shape[2]
        cd = x.dtype
        cos, sin = rotary_cos_sin(L, El // heads, dtype=cd, device=x.device)
        x2 = x.reshape(B * L, E)
        w3c = torch.cat(w3.unbind(0), dim=1).to(cd)
        ls1 = _f32(ls1)
        xn, qkv, att = _attn_forward(x2, pad, w3c, _f32(b3.reshape(3 * El)), cos, sin, ls1,
                                     _f32(lb1), B, L, heads)
        dyc = dy.to(cd).reshape(B * L, E).contiguous()
        dwo, dbo = gemm_dw(att, dyc), col_sum(dyc)
        dattn = gemm_dx(dyc, wo.to(cd).contiguous()).view(B, L, El)
        dqkv = esm2_attention_bwd(qkv, dattn, pad, cos, sin, heads=heads).view(B * L, 3 * El)
        dxn = all_reduce_(gemm_dx(dqkv, w3c, out_dtype=torch.float32), tp)
        dw3 = torch.stack(gemm_dw(xn, dqkv).split(El, dim=1))
        db3 = col_sum(dqkv).view(3, El)
        dx, dls1, dlb1 = layernorm_bwd(x2, dxn, ls1, residual=dyc, eps=LN_EPS, out_dtype=cd)
        return dx.view(B, L, E), None, dw3, db3, dwo, dbo, dls1, dlb1, None, None


class FFResidualBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ls2, lb2, w1, b1, w2, b2, gelu, tp):
        B, L, E = x.shape
        cd = x.dtype
        x2 = x.reshape(B * L, E)
        u = layernorm(x2, _f32(ls2), _f32(lb2), eps=LN_EPS, out_dtype=cd)
        g = gemm_bias_act(u, w1.to(cd).contiguous(), _f32(b1), act=gelu)
        y = row_parallel(g, w2.to(cd).contiguous(), _f32(b2), x2, tp, cd)
        ctx.save_for_backward(x, ls2, lb2, w1, b1, w2)
        ctx.gelu, ctx.tp = gelu, tp
        return y.view(B, L, E)

    @staticmethod
    def backward(ctx, dy):
        x, ls2, lb2, w1, b1, w2 = ctx.saved_tensors
        gelu, tp = ctx.gelu, ctx.tp
        B, L, E = x.shape
        cd = x.dtype
        x2 = x.reshape(B * L, E)
        ls2 = _f32(ls2)
        w1c, w2c = w1.to(cd).contiguous(), w2.to(cd).contiguous()
        u = layernorm(x2, ls2, _f32(lb2), eps=LN_EPS, out_dtype=cd)
        g, h1 = gemm_bias_act(u, w1c, _f32(b1), act=gelu, want_pre=True)
        dyc = dy.to(cd).reshape(B * L, E).contiguous()
        dw2, db2 = gemm_dw(g, dyc), col_sum(dyc)
        dh1 = gemm_dx(dyc, w2c, gelu_of=h1, gelu=gelu)
        dw1, db1 = gemm_dw(u, dh1), col_sum(dh1)
        du = all_reduce_(gemm_dx(dh1, w1c, out_dtype=torch.float32), tp)
        dx, dls2, dlb2 = layernorm_bwd(x2, du, ls2, residual=dyc, eps=LN_EPS, out_dtype=cd)
        return dx.view(B, L, E), dls2, dlb2, dw1, db1, dw2, db2, None, None


def _check(x: torch.Tensor, heads: int | None = None) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected x (B, L, E), got shape {tuple(x.shape)}")
    if heads is not None and x.shape[2] % heads:
        # the TPU kernel's check (esm2_block_tpu.py:509-514)
        raise ValueError(f"esm2_attn_block needs E % heads == 0 (got E={x.shape[2]}, "
                         f"heads={heads})")


def esm2_attn_block(x: torch.Tensor, padding_mask: torch.Tensor, w3, b3, wo, bo, ls1, lb1, *,
                    heads: int, tp=None) -> torch.Tensor:
    """Differentiable pre-LN rotary attention half → x + attn_out: x (B, L,
    E) in the compute dtype, padding_mask (B, L) True at PAD keys, w3 (3, E,
    E) and b3 (3, E) the stacked q/k/v projections, wo (E, E), bo, ls1, lb1
    (E,) → (B, L, E) in x's dtype.  Under ``tp`` w3 (3, E, E/tp) and wo
    (E/tp, E) are the rank's shards, b3 whole, ``heads`` the layer's."""
    _check(x, heads)
    if tp is not None:
        heads, _ = tp.heads(heads)
        b3 = scatter_to_tp(b3, tp, 1)
    return Esm2AttnBlockFn.apply(x.contiguous(), padding_mask.to(torch.int32).contiguous(), w3,
                                 b3, wo, bo, ls1, lb1, heads, tp)


def ff_residual_block(x: torch.Tensor, ls2, lb2, w1, b1, w2, b2, *,
                      gelu: str = "erf", tp=None) -> torch.Tensor:
    """Differentiable pre-LN FF half → x + W2·gelu(W1·LN(x) + b1) + b2: w1
    (E, F), w2 (F, E) in the (in, out) layout; under ``tp`` the rank's
    shards (E, F/tp) and (F/tp, E), b1 whole."""
    _check(x)
    if gelu not in ("erf", "tanh"):
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
    return FFResidualBlockFn.apply(x.contiguous(), ls2, lb2, w1, scatter_to_tp(b1, tp), w2, b2,
                                   gelu, tp)


def esm2_layer_block(x: torch.Tensor, padding_mask: torch.Tensor, w3, b3, wo, bo, ls1, lb1,
                     ls2, lb2, w1, b1, w2, b2, *, heads: int, gelu: str = "erf",
                     tp=None) -> torch.Tensor:
    """The whole ESM2 layer: attention half, then FF half; ``tp`` (a
    ``parallel/tensor.TensorParallel``) runs both on the rank's shards."""
    xa = esm2_attn_block(x, padding_mask, w3, b3, wo, bo, ls1, lb1, heads=heads, tp=tp)
    return ff_residual_block(xa, ls2, lb2, w1, b1, w2, b2, gelu=gelu, tp=tp)
