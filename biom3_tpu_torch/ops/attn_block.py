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


def _forward(xn2, w3, wo, bo, B, L, *, local_heads, heads, window):
    d = xn2.shape[1]
    qkv = gemm_bias_act(xn2, w3).view(B, L, 3 * d)
    att = stage3_attention_core(qkv, heads=heads, local_heads=local_heads, window=window)
    return qkv, att.view(B * L, d), gemm_bias_act(att.view(B * L, d), wo, bo)


class AttnBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, wq, wk, wv, wo, bo, local_heads, heads, window):
        B, L, d = xn.shape
        cd = xn.dtype
        w3 = torch.cat([wq, wk, wv], dim=1).to(cd)
        _, _, out = _forward(xn.reshape(B * L, d), w3, wo.to(cd).contiguous(),
                             bo.float().contiguous(), B, L, local_heads=local_heads,
                             heads=heads, window=window)
        ctx.save_for_backward(xn, wq, wk, wv, wo, bo)
        ctx.cfg = dict(local_heads=local_heads, heads=heads, window=window)
        return out.view(B, L, d)

    @staticmethod
    def backward(ctx, dout):
        xn, wq, wk, wv, wo, bo = ctx.saved_tensors
        B, L, d = xn.shape
        cd = xn.dtype
        xn2 = xn.reshape(B * L, d)
        w3 = torch.cat([wq, wk, wv], dim=1).to(cd)
        wo_c = wo.to(cd).contiguous()
        qkv, att, _ = _forward(xn2, w3, wo_c, bo.float().contiguous(), B, L, **ctx.cfg)
        do = dout.to(cd).reshape(B * L, d).contiguous()
        dwo = gemm_dw(att, do)
        dbo = col_sum(do)
        dattn = gemm_dx(do, wo_c).view(B, L, d)
        dqkv = stage3_attention_bwd(qkv, dattn, **ctx.cfg).view(B * L, 3 * d)
        dxn = gemm_dx(dqkv, w3).view(B, L, d)
        dwq, dwk, dwv = gemm_dw(xn2, dqkv).split(d, dim=1)
        return dxn, dwq, dwk, dwv, dwo, dbo, None, None, None


def split_attention_block(xn: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, *,
                          local_heads: int, heads: int, window: int = 128) -> torch.Tensor:
    """xn (B, L, d) post-LayerNorm input in the compute dtype; wq, wk, wv,
    wo (d, d) (in, out); bo (d,) → (B, L, d) in xn's dtype, differentiable
    in every argument."""
    L = xn.shape[1]
    if local_heads and L % window:
        raise ValueError(f"attention block needs L % window == 0 with local heads "
                         f"(got L={L}, window={window})")
    return AttnBlockFn.apply(xn.contiguous(), wq, wk, wv, wo, bo, local_heads, heads, window)
