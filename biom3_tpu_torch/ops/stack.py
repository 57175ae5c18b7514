"""Whole-stack ProteoScribe forward for one denoise step.

Counterpart of ``biom3_tpu/ops/pallas/stack_kernel_tpu.py::fused_stack_logits``
(:765-1061): the same inputs — ids (B, L), decode positions (B, k), the
per-layer bias (B, depth, d), stacked (depth, …) weights in (d_in, d_out)
layout — and the same output, (B, k, C) f32 logits at the decode positions.

On the TPU this is one persistent kernel with every layer's weights
resident in VMEM.  Hopper cannot hold them: 16 layers of bf16 weights are
~100 MB against 228 KB of shared memory per SM and a 50 MB L2.  Here it is
a chain of kernels — ``embed_tokens`` → ``depth`` × (attention half, FF
half; ``ops.stage3_layer``) → ``gather_head`` — with the residual in bf16
between layers and in f32 inside a layer, the TPU kernel's rounding points
(stack_kernel_tpu.py:540-560).
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import embed_tokens, gather_head
from biom3_tpu_torch.ops.stage3_layer import LN_EPS, attn_half, ff_half


def pack_stack_weights(tok_table, pos_emb, ln1_scale, ln1_bias, wq, wk, wv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2, fn_scale, fn_bias, head_w,
                       head_b) -> dict:
    """Gather the stack's weights into the dict ``stack_logits`` reads, with
    q/k/v fused to one (depth, d, 3d) product."""
    return dict(
        tok=tok_table, pos_emb=pos_emb, ln1_scale=ln1_scale, ln1_bias=ln1_bias,
        wqkv=torch.cat([wq, wk, wv], dim=2).contiguous(), wo=wo, bo=bo,
        ln2_scale=ln2_scale, ln2_bias=ln2_bias, w1=w1, b1=b1, w2=w2, b2=b2,
        fn_scale=fn_scale, fn_bias=fn_bias, head_w=head_w, head_b=head_b,
    )


def stack_logits(ids: torch.Tensor, pos: torch.Tensor, bias: torch.Tensor, w: dict, *,
                 local_heads: int, heads: int, window: int, gelu: str) -> torch.Tensor:
    """ids (B, L) int32, pos (B, k) int32, bias (B, depth, d) in the weights'
    dtype, ``w`` from ``pack_stack_weights`` → (B, k, C) f32."""
    cdtype = w["tok"].dtype
    depth = w["wqkv"].shape[0]
    if bias.dim() != 3 or bias.shape[1] != depth:
        raise ValueError(f"bias: shape {tuple(bias.shape)} is not (B, {depth}, d)")
    bias_l = bias.to(cdtype).transpose(0, 1).contiguous()      # (depth, B, d)
    h = embed_tokens(ids, w["tok"], w["pos_emb"])
    for l in range(depth):
        x1 = attn_half(h, bias_l[l], w["ln1_scale"][l], w["ln1_bias"][l], w["wqkv"][l],
                       w["wo"][l], w["bo"][l], local_heads=local_heads, heads=heads,
                       window=window, out_dtype=torch.float32)
        h = ff_half(x1, w["ln2_scale"][l], w["ln2_bias"][l], w["w1"][l], w["b1"][l],
                    w["w2"][l], w["b2"][l], gelu=gelu, cdtype=cdtype, out_dtype=cdtype)
    return gather_head(h, pos, w["fn_scale"], w["fn_bias"], w["head_w"], w["head_b"],
                       eps=LN_EPS)


def fused_stack_logits(ids, pos, bias, tok_table, pos_emb, ln1_scale, ln1_bias, wq, wk, wv,
                       wo, bo, ln2_scale, ln2_bias, w1, b1, w2, b2, fn_scale, fn_bias,
                       head_w, head_b, *, local_heads: int, heads: int, window: int = 128,
                       gelu: str = "erf") -> torch.Tensor:
    """Full serving forward → (B, k, C) f32 logits at the decode positions."""
    w = pack_stack_weights(tok_table, pos_emb, ln1_scale, ln1_bias, wq, wk, wv, wo, bo,
                           ln2_scale, ln2_bias, w1, b1, w2, b2, fn_scale, fn_bias, head_w,
                           head_b)
    return stack_logits(ids, pos, bias, w, local_heads=local_heads, heads=heads,
                        window=window, gelu=gelu)
