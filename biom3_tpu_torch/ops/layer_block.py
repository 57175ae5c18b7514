"""Whole Stage-3 TransformerLayer with a hand-written backward, for training.

Counterpart of ``biom3_tpu/ops/pallas/layer_block_tpu.py:47-571``
(``layer_block``, a ``custom_vjp`` wrapped by ``transformer_layer_block``):

  v = LN1(x)·γ1+β1 ; a = AttnBlock(v) ; xa = x + a
  u = LN2(xa)·γ2+β2; f = W2·gelu(W1·u + b1) + b2 ; y = xa + f

* Forward: the chain the serving path runs (``ops/stage3_layer.py``), at
  the TPU kernel's rounding points (``layer_block_tpu.py:108-157``):
  ``layernorm`` → q/k/v ``gemm_bias_act`` → ``stage3_attention_core`` →
  out-projection ``gemm_bias_act`` with +bo and the residual, xa kept f32 →
  ``layernorm`` → W1 ``gemm_bias_act`` with +b1 and GELU → W2
  ``gemm_bias_act`` with +b2 and the residual xa.
* Only the layer input is saved.  The backward follows
  ``_layer_bwd_kernel``'s order (``:160-371``): recompute through xa; the
  FF/LN2 backward (dW2 = gᵀ·dy, db2, dh1 = (dy·W2ᵀ)∘gelu'(h1) in the GEMM's
  epilogue, dW1, db1, du = dh1·W1ᵀ, ``layernorm_bwd`` adds dy) gives dxa;
  then dWo, dbo, dattn = dxa·Woᵀ, ``stage3_attention_bwd``, dxn1 =
  dqkv·W3ᵀ, dW3, and ``layernorm_bwd`` of LN1 adds dxa: dx = dxa + dx_ln.

Under tp (``transformer_layer_block(..., tp=)``) the layer runs Megatron
on the rank's shards (``parallel/tensor.py``), with all-reduces over tp of
(B·L, d) f32 tensors: xa and y in the forward; in the backward xa again
(the recompute, so that the layer still saves only its input), then du
and dxn1 before their ``layernorm_bwd``.

LayerNorm eps is 1e-6 (flax's default).  The weights come in as the f32
master parameters in the (d_in, d_out) layout and are cast inside; their
gradients leave in f32 (the TPU wrapper rounds them to the bf16 copy's
dtype, ``layer_block_tpu.py:512-519``).  Dropout has no place here, as in
the TPU kernel.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import (
    col_sum,
    gemm_bias_act,
    gemm_dw,
    gemm_dx,
    layernorm,
    layernorm_bwd,
    stage3_attention_bwd,
    stage3_attention_core,
)
from biom3_tpu_torch.parallel.tensor import all_reduce_, row_parallel, scatter_to_tp

LN_EPS = 1e-6


def _attn_forward(x2, p, B, L, cfg, tp):
    """→ (xn1, qkv, attn, xa f32) of the attention half.  Under tp qkv and
    attn hold the rank's heads, and xa is the sum over tp of the ranks'
    out-projections, rank 0's with +bo and the residual."""
    dl = p["wo"].shape[0]
    xn1 = layernorm(x2, p["ls1"], p["lb1"], eps=LN_EPS, out_dtype=x2.dtype)
    qkv = gemm_bias_act(xn1, p["w3"]).view(B, L, 3 * dl)
    att = stage3_attention_core(qkv, heads=cfg["heads"], local_heads=cfg["local_heads"],
                                window=cfg["window"]).view(B * L, dl)
    return xn1, qkv, att, row_parallel(att, p["wo"], p["bo"], x2, tp, torch.float32)


def _ff_forward(xa, p, cfg, cd, tp):
    """xa + W2·gelu(W1·LN2(xa) + b1) + b2 in ``cd`` (under tp W1's columns
    and W2's rows the rank's, the W2 products summed over tp)."""
    u = layernorm(xa, p["ls2"], p["lb2"], eps=LN_EPS, out_dtype=cd)
    g = gemm_bias_act(u, p["w1"], p["b1"], act=cfg["gelu"])
    return row_parallel(g, p["w2"], p["b2"], xa, tp, cd)


def _cast(x, wq, wk, wv, wo, bo, ls1, lb1, ls2, lb2, w1, b1, w2, b2) -> dict:
    cd = x.dtype
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return dict(w3=torch.cat([wq, wk, wv], dim=1).to(cd), wo=wo.to(cd).contiguous(),
                w1=w1.to(cd).contiguous(), w2=w2.to(cd).contiguous(), bo=f32(bo), ls1=f32(ls1),
                lb1=f32(lb1), ls2=f32(ls2), lb2=f32(lb2), b1=f32(b1), b2=f32(b2))


class LayerBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, wk, wv, wo, bo, ls1, lb1, ls2, lb2, w1, b1, w2, b2,
                local_heads, heads, window, gelu, tp):
        B, L, d = x.shape
        cfg = dict(local_heads=local_heads, heads=heads, window=window, gelu=gelu)
        p = _cast(x, wq, wk, wv, wo, bo, ls1, lb1, ls2, lb2, w1, b1, w2, b2)
        x2 = x.reshape(B * L, d)
        *_, xa = _attn_forward(x2, p, B, L, cfg, tp)
        y = _ff_forward(xa, p, cfg, x.dtype, tp)
        ctx.save_for_backward(x, wq, wk, wv, wo, bo, ls1, lb1, ls2, lb2, w1, b1, w2, b2)
        ctx.cfg, ctx.tp = cfg, tp
        return y.view(B, L, d)

    @staticmethod
    def backward(ctx, dy):
        x, *weights = ctx.saved_tensors
        cfg, tp = ctx.cfg, ctx.tp
        B, L, d = x.shape
        cd = x.dtype
        p = _cast(x, *weights)
        dl = p["wo"].shape[0]
        x2 = x.reshape(B * L, d)
        # recompute through xa (under tp its all-reduce again)
        xn1, qkv, att, xa = _attn_forward(x2, p, B, L, cfg, tp)
        u = layernorm(xa, p["ls2"], p["lb2"], eps=LN_EPS, out_dtype=cd)
        g, h1 = gemm_bias_act(u, p["w1"], p["b1"], act=cfg["gelu"], want_pre=True)
        # FF / LN2 backward → dxa; under tp du sums the ranks' partial products
        dyc = dy.to(cd).reshape(B * L, d).contiguous()
        dw2, db2 = gemm_dw(g, dyc), col_sum(dyc)
        dh1 = gemm_dx(dyc, p["w2"], gelu_of=h1, gelu=cfg["gelu"])
        dw1, db1 = gemm_dw(u, dh1), col_sum(dh1)
        du = all_reduce_(gemm_dx(dh1, p["w1"], out_dtype=torch.float32), tp)
        (dxa, dxa_c), dls2, dlb2 = layernorm_bwd(xa, du, p["ls2"], residual=dyc, eps=LN_EPS,
                                                 out_dtype=torch.float32, want_cd=True)
        # attention / LN1 backward → dx = dxa + dx_ln; under tp dxn1 as du
        dwo, dbo = gemm_dw(att, dxa_c), col_sum(dxa)
        dattn = gemm_dx(dxa_c, p["wo"]).view(B, L, dl)
        dqkv = stage3_attention_bwd(qkv, dattn, heads=cfg["heads"],
                                    local_heads=cfg["local_heads"],
                                    window=cfg["window"]).view(B * L, 3 * dl)
        dxn1 = all_reduce_(gemm_dx(dqkv, p["w3"], out_dtype=torch.float32), tp)
        dwq, dwk, dwv = gemm_dw(xn1, dqkv).split(dl, dim=1)
        dx, dls1, dlb1 = layernorm_bwd(x2, dxn1, p["ls1"], residual=dxa, eps=LN_EPS,
                                       out_dtype=cd)
        return (dx.view(B, L, d), dwq, dwk, dwv, dwo, dbo, dls1, dlb1, dls2, dlb2, dw1, db1,
                dw2, db2, None, None, None, None, None)


def transformer_layer_block(xb: torch.Tensor, wq, wk, wv, wo, bo, ls1, lb1, ls2, lb2,
                            w1, b1, w2, b2, *, local_heads: int, heads: int,
                            window: int = 128, gelu: str = "erf", tp=None) -> torch.Tensor:
    """Differentiable fused TransformerLayer: xb (B, L, d) layer input (x +
    per-layer bias) in the compute dtype; wq, wk, wv, wo (d, d), w1 (d, F),
    w2 (F, d) in the (in, out) layout; bo, b2, LayerNorm params (d,), b1
    (F,) → (B, L, d) in xb's dtype.

    ``tp`` (a ``parallel/tensor.TensorParallel``): Megatron over the tp
    ranks.  wq, wk, wv and w1 are then the rank's column shards (d, d/tp)
    and (d, F/tp), wo and w2 its row shards (d/tp, d) and (F/tp, d), the
    biases and LayerNorm parameters whole; ``heads`` and ``local_heads``
    count the whole layer's heads, of which the rank runs its contiguous
    block.  The output and every gradient of a whole parameter are the
    same on every tp rank.

    The TPU kernel's further check, window % 128 == 0 and d % 128 == 0
    (``layer_block_tpu.py:542-550``), is a Mosaic lane-tiling limit with no
    counterpart here; the kernels check their own shapes."""
    L = xb.shape[1]
    if local_heads and L % window:
        raise ValueError(f"layer-block needs L % window == 0 with local heads "
                         f"(got L={L}, window={window})")
    if gelu not in ("erf", "tanh"):
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
    if tp is not None:
        heads, local_heads = tp.heads(heads, local_heads)
        b1 = scatter_to_tp(b1, tp)
    return LayerBlockFn.apply(xb.contiguous(), wq, wk, wv, wo, bo, ls1, lb1, ls2, lb2, w1, b1,
                              w2, b2, local_heads, heads, window, gelu, tp)
