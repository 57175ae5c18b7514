"""Stage-3 attention sub-block with a hand-written backward, for training.

Counterpart of ``biom3_tpu/ops/pallas/attn_block_tpu.py:123-482``
(``attn_block``, a ``custom_vjp`` wrapped by ``split_attention_block``):
q/k/v projections, band-local + linear heads, out-projection with bias.

* Forward: the q/k/v ``gemm_bias_act`` (one d x 3d product) →
  ``stage3_attention_core`` → the out-projection ``gemm_bias_act`` with +bo.
* Only ``xn`` is saved (``attn_block_tpu.py:437-443``).  The backward
  recomputes q/k/v and the attention output, then: dWo = attnᵀ·dout
  (``gemm_dw``), dbo = Σ dout (``col_sum``), dattn = dout·Woᵀ (``gemm_dx``),
  dqkv by ``stage3_attention_bwd`` (every softmax recomputed), dxn =
  dqkv·W3ᵀ (``gemm_dx``) and dW3 = xnᵀ·dqkv (``gemm_dw``).

The weights come in as the f32 master parameters in the (d_in, d_out)
layout and are cast to xn's dtype inside; their gradients leave in f32
(the TPU wrapper rounds them to the bf16 copy's dtype instead,
``attn_block_tpu.py:454-459``).  On the card xn is bf16 and every product
runs on the port's kernels; on the CPU everything is f32 on their plain
versions.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import (
    col_sum,
    gemm_bias_act,
    gemm_dw,
    gemm_dx,
    stage3_attention_bwd,
    stage3_attention_core,
)


def _forward(xn2, w3, wo, bo, B, L, *, local_heads, heads, window, out_dtype=None):
    dl = w3.shape[1] // 3
    qkv = gemm_bias_act(xn2, w3).view(B, L, 3 * dl)
    att = stage3_attention_core(qkv, heads=heads, local_heads=local_heads, window=window)
    return qkv, att.view(B * L, dl), gemm_bias_act(att.view(B * L, dl), wo, bo,
                                                   out_dtype=out_dtype)


class AttnBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, wq, wk, wv, wo, bo, local_heads, heads, window, out_dtype):
        B, L, d = xn.shape
        cd = xn.dtype
        w3 = torch.cat([wq, wk, wv], dim=1).to(cd)
        _, _, out = _forward(xn.reshape(B * L, d), w3, wo.to(cd).contiguous(),
                             None if bo is None else bo.float().contiguous(), B, L,
                             local_heads=local_heads, heads=heads, window=window,
                             out_dtype=out_dtype)
        ctx.save_for_backward(xn, wq, wk, wv, wo)
        ctx.cfg = dict(local_heads=local_heads, heads=heads, window=window)
        ctx.bias = bo is not None
        return out.view(B, L, d)

    @staticmethod
    def backward(ctx, dout):
        xn, wq, wk, wv, wo = ctx.saved_tensors
        B, L, d = xn.shape
        dl = wo.shape[0]
        cd = xn.dtype
        xn2 = xn.reshape(B * L, d)
        w3 = torch.cat([wq, wk, wv], dim=1).to(cd)
        wo_c = wo.to(cd).contiguous()
        qkv, att, _ = _forward(xn2, w3, wo_c, None, B, L, **ctx.cfg)
        do = dout.to(cd).reshape(B * L, d).contiguous()
        dwo = gemm_dw(att, do)
        dbo = col_sum(do) if ctx.bias else None
        dattn = gemm_dx(do, wo_c).view(B, L, dl)
        dqkv = stage3_attention_bwd(qkv, dattn, **ctx.cfg).view(B * L, 3 * dl)
        dxn = gemm_dx(dqkv, w3).view(B, L, d)
        dwq, dwk, dwv = gemm_dw(xn2, dqkv).split(dl, dim=1)
        return dxn, dwq, dwk, dwv, dwo, dbo, None, None, None, None


def split_attention_block(xn: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor | None, *,
                          local_heads: int, heads: int, window: int = 128,
                          out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """xn (B, L, d) post-LayerNorm input in the compute dtype; wq, wk, wv
    (d, d') and wo (d', d) in the (in, out) layout, d' = d or, under tp,
    the rank's heads' columns (``heads`` and ``local_heads`` then count the
    rank's heads); bo (d,) or None → (B, L, d) in ``out_dtype`` (default
    xn's dtype), differentiable in every argument."""
    L = xn.shape[1]
    if local_heads and L % window:
        raise ValueError(f"attention block needs L % window == 0 with local heads "
                         f"(got L={L}, window={window})")
    return AttnBlockFn.apply(xn.contiguous(), wq, wk, wv, wo, bo, local_heads, heads, window,
                             out_dtype)
