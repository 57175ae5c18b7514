"""One ProteoScribe layer as two halves on the port's kernels.

Counterpart of ``biom3_tpu/ops/pallas/fused_layer_tpu.py``: the same
arguments and semantics as ``fused_attn_half`` (:186-246) and
``fused_ff_half`` (:269-316), weights in the JAX package's (d_in, d_out)
layout.  Each half is a short chain of kernels (``ops.kernels``):

* attention half: ``bias_layernorm`` → q/k/v ``gemm_bias_act`` (one
  d x 3d product) → ``stage3_attention_core`` (``stage3_attention_core_i8``
  under ``attn_quant="int8"``) → out-projection
  ``gemm_bias_act`` with +bo and the residual xb;
* FF half: ``layernorm`` → W1 ``gemm_bias_act`` with +b1 and GELU → W2
  ``gemm_bias_act`` with +b2 and the residual.

Given int8 weights ((d_out, d_in) codes with per-output-channel scales,
``ops/quant.py``) each product becomes ``quant_rows`` → ``gemm_i8``
(``ops/kernels.linear_i8``) at the TPU kernel's rounding points
(stack_kernel_tpu.py:77-84, :347-359, :474-486): the projections quantize
the LayerNorm output after its rounding to the compute dtype and the bf16
attention output; the FF quantizes the f32 LayerNorm output and the f32
GELU output, so W1's product leaves in f32.

The bias folds into the residual stream for good: the attention half
returns ``xb + attn(LN(xb))`` with ``xb = x + bias``.  LayerNorm eps is
1e-6 (flax's default, fused_layer_tpu.py:82).  ``attn_half``/``ff_half``
take the q/k/v weights packed and an output dtype, so the whole-stack
forward (``ops.stack``) keeps the residual in f32 between the halves of a
layer, as the TPU kernel does.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import (
    bias_layernorm,
    gelu,
    gemm_bias_act,
    layernorm,
    linear_i8,
    stage3_attention_core,
    stage3_attention_core_i8,
)

__all__ = ["attn_half", "ff_half", "fused_attn_half", "fused_ff_half", "gelu", "layernorm"]

LN_EPS = 1e-6


def attn_half(h, bias, ln_scale, ln_bias, wqkv, wo, bo, *, local_heads: int, heads: int,
              window: int, out_dtype: torch.dtype, sqkv=None, so=None,
              attn_quant: str = "none") -> torch.Tensor:
    """h (B, L, d), bias (B, d) in h's dtype, wqkv (d, 3d) → (B, L, d).
    With ``sqkv``/``so``: int8 wqkv (3d, d) and wo (d, d) with their
    scales.  ``attn_quant="int8"``: the band-local heads' products in int8
    (``stage3_attention_core_i8``)."""
    B, L, d = h.shape
    xb, xn = bias_layernorm(h, bias, ln_scale, ln_bias, eps=LN_EPS)
    xn, xb = xn.view(B * L, d), xb.view(B * L, d)
    if sqkv is None:
        qkv = gemm_bias_act(xn, wqkv)
    else:
        qkv = linear_i8(xn, wqkv, sqkv, out_dtype=h.dtype)
    core = stage3_attention_core_i8 if attn_quant == "int8" else stage3_attention_core
    att = core(qkv.view(B, L, 3 * d), heads=heads, local_heads=local_heads,
               window=window).view(B * L, d)
    if so is None:
        out = gemm_bias_act(att, wo, bo, residual=xb, out_dtype=out_dtype)
    else:
        out = linear_i8(att, wo, so, bo, residual=xb, out_dtype=out_dtype)
    return out.view(B, L, d)


def ff_half(x, ln_scale, ln_bias, w1, b1, w2, b2, *, gelu: str, cdtype: torch.dtype,
            out_dtype: torch.dtype, s1=None, s2=None) -> torch.Tensor:
    """x (B, L, d) in f32 or ``cdtype`` → x + FF(LN(x)) in ``out_dtype``.
    With ``s1``/``s2``: int8 w1 (4d, d) and w2 (d, 4d) with their scales."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if s1 is None:
        xn = layernorm(x2, ln_scale, ln_bias, eps=LN_EPS, out_dtype=cdtype)
        mid = gemm_bias_act(xn, w1, b1, act=gelu)
        out = gemm_bias_act(mid, w2, b2, residual=x2, out_dtype=out_dtype)
    else:
        xn = layernorm(x2, ln_scale, ln_bias, eps=LN_EPS, out_dtype=torch.float32)
        mid = linear_i8(xn, w1, s1, b1, act=gelu, out_dtype=torch.float32)
        out = linear_i8(mid, w2, s2, b2, residual=x2, out_dtype=out_dtype)
    return out.view(x.shape)


def fused_attn_half(x, bias, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, local_heads: int,
                    heads: int, window: int = 128) -> torch.Tensor:
    """x (B, L, d); bias (B, d) per-layer additive bias (time + cond) in
    x's dtype; weights (d_in, d_out).  Returns x + bias + attention(LN(x +
    bias)) in x's dtype."""
    wqkv = torch.cat([wq, wk, wv], dim=1)
    return attn_half(x, bias, ln_scale, ln_bias, wqkv, wo, bo, local_heads=local_heads,
                     heads=heads, window=window, out_dtype=x.dtype)


def fused_ff_half(x, ln_scale, ln_bias, w1, b1, w2, b2, *, gelu: str = "erf") -> torch.Tensor:
    """x (B, L, d) → x + FF(LN(x)); FF = Dense(4d) → GELU → Dense(d)."""
    return ff_half(x, ln_scale, ln_bias, w1, b1, w2, b2, gelu=gelu, cdtype=x.dtype,
                   out_dtype=x.dtype)
