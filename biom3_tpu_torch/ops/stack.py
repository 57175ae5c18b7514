"""Whole-stack ProteoScribe forward for one denoise step.

Counterpart of ``biom3_tpu/ops/pallas/stack_kernel_tpu.py::fused_stack_logits``
(:765-1061): the same inputs — ids (B, L), decode positions (B, k), the
per-layer bias (B, depth, d), stacked (depth, …) weights in (d_in, d_out)
layout — and the same output, (B, k, C) f32 logits at the decode positions.

On the TPU this is one persistent kernel with every layer's weights
resident in VMEM.  Hopper cannot hold them: 16 layers of bf16 weights are
~100 MB against 228 KB of shared memory per SM and a 50 MB L2.  Here it is
a chain of kernels — ``embed_tokens`` → ``depth`` × (attention half, FF
half; ``ops.stage3_layer``) → ``gather_head`` at k positions, up to every
one (``pos`` (B, L): the full grid) — with the residual in bf16
between layers and in f32 inside a layer, the TPU kernel's rounding points
(stack_kernel_tpu.py:540-560).

The TPU kernel's ``attn_quant="int8"`` (stack_kernel_tpu.py:112-180, the
band-local heads' QKᵀ and PV in int8) selects
``stage3_attention_core_i8`` for each layer's attention.  The TPU kernel
takes it only on its resident ``stream="dl"`` layout (:842-847), a rule of
the TPU's layouts; here it works on the (L, d) rows of every call.  Its
int8 options ``ff_quant``/``proj_quant`` are the weights' type here: int8
w1/w2 (FF) or wq/wk/wv/wo (projections), each
(depth, d_out, d_in) — ``gemm_i8``'s layout — with its (depth, d_out) f32
scales ``s1, s2`` or ``sq, sk, sv, so`` from ``ops/quant.py``.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import embed_tokens, gather_head, pad_head
from biom3_tpu_torch.ops.stage3_layer import LN_EPS, attn_half, ff_half


def pack_stack_weights(tok_table, pos_emb, ln1_scale, ln1_bias, wq, wk, wv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2, fn_scale, fn_bias, head_w,
                       head_b, s1=None, s2=None, sq=None, sk=None, sv=None,
                       so=None) -> dict:
    """Gather the stack's weights into the dict ``stack_logits`` reads, with
    q/k/v fused to one (depth, d, 3d) product — (depth, 3d, d) in int8 —
    and the (d, C) head padded to ``gather_head``'s (d, 32)."""
    proj8 = wq.dtype == torch.int8
    return dict(
        tok=tok_table, pos_emb=pos_emb, ln1_scale=ln1_scale, ln1_bias=ln1_bias,
        wqkv=torch.cat([wq, wk, wv], dim=1 if proj8 else 2).contiguous(), wo=wo, bo=bo,
        sqkv=torch.cat([sq, sk, sv], dim=1).contiguous() if proj8 else None, so=so,
        ln2_scale=ln2_scale, ln2_bias=ln2_bias, w1=w1, b1=b1, w2=w2, b2=b2, s1=s1, s2=s2,
        fn_scale=fn_scale, fn_bias=fn_bias, head_w=pad_head(head_w).contiguous(),
        head_b=head_b,
    )


def _layer(t, l):
    return None if t is None else t[l]


QUANT_MODES = ("none", "int8")   # ff_quant, proj_quant and attn_quant


def stack_logits(ids: torch.Tensor, pos: torch.Tensor, bias: torch.Tensor, w: dict, *,
                 local_heads: int, heads: int, window: int, gelu: str,
                 attn_quant: str = "none") -> torch.Tensor:
    """ids (B, L) int32, pos (B, k) int32, bias (B, depth, d) in the weights'
    dtype, ``w`` from ``pack_stack_weights`` → (B, k, C) f32.
    ``attn_quant="int8"``: the band-local heads' QKᵀ and PV in int8
    (``ops.kernels.stage3_attention_core_i8``)."""
    if attn_quant not in QUANT_MODES:
        raise ValueError(f"attn_quant must be 'none' or 'int8', got {attn_quant!r}")
    cdtype = w["tok"].dtype
    depth = w["wqkv"].shape[0]
    if bias.dim() != 3 or bias.shape[1] != depth:
        raise ValueError(f"bias: shape {tuple(bias.shape)} is not (B, {depth}, d)")
    bias_l = bias.to(cdtype).transpose(0, 1).contiguous()      # (depth, B, d)
    h = embed_tokens(ids, w["tok"], w["pos_emb"])
    for l in range(depth):
        x1 = attn_half(h, bias_l[l], w["ln1_scale"][l], w["ln1_bias"][l], w["wqkv"][l],
                       w["wo"][l], w["bo"][l], local_heads=local_heads, heads=heads,
                       window=window, out_dtype=torch.float32, sqkv=_layer(w["sqkv"], l),
                       so=_layer(w["so"], l), attn_quant=attn_quant)
        h = ff_half(x1, w["ln2_scale"][l], w["ln2_bias"][l], w["w1"][l], w["b1"][l],
                    w["w2"][l], w["b2"][l], gelu=gelu, cdtype=cdtype, out_dtype=cdtype,
                    s1=_layer(w["s1"], l), s2=_layer(w["s2"], l))
    return gather_head(h, pos, w["fn_scale"], w["fn_bias"], w["head_w"], w["head_b"],
                       eps=LN_EPS)


def fused_stack_logits(ids, pos, bias, tok_table, pos_emb, ln1_scale, ln1_bias, wq, wk, wv,
                       wo, bo, ln2_scale, ln2_bias, w1, b1, w2, b2, fn_scale, fn_bias,
                       head_w, head_b, s1=None, s2=None, sq=None, sk=None, sv=None, so=None,
                       *, local_heads: int, heads: int, window: int = 128,
                       gelu: str = "erf", attn_quant: str = "none") -> torch.Tensor:
    """Full serving forward → (B, k, C) f32 logits at the decode positions."""
    w = pack_stack_weights(tok_table, pos_emb, ln1_scale, ln1_bias, wq, wk, wv, wo, bo,
                           ln2_scale, ln2_bias, w1, b1, w2, b2, fn_scale, fn_bias, head_w,
                           head_b, s1, s2, sq, sk, sv, so)
    return stack_logits(ids, pos, bias, w, local_heads=local_heads, heads=heads,
                        window=window, gelu=gelu, attn_quant=attn_quant)
