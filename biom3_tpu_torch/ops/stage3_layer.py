"""One ProteoScribe layer as two halves on the port's kernels.

Counterpart of ``biom3_tpu/ops/pallas/fused_layer_tpu.py``: the same
arguments and semantics as ``fused_attn_half`` (:186-246) and
``fused_ff_half`` (:269-316), weights in the JAX package's (d_in, d_out)
layout.  Each half is a short chain of kernels (``ops.kernels``):

* attention half: ``bias_layernorm`` → q/k/v ``gemm_bias_act`` (one
  d x 3d product) → ``stage3_attention_core`` → out-projection
  ``gemm_bias_act`` with +bo and the residual xb;
* FF half: ``layernorm`` → W1 ``gemm_bias_act`` with +b1 and GELU → W2
  ``gemm_bias_act`` with +b2 and the residual.

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
    stage3_attention_core,
)

__all__ = ["attn_half", "ff_half", "fused_attn_half", "fused_ff_half", "gelu", "layernorm"]

LN_EPS = 1e-6


def attn_half(h, bias, ln_scale, ln_bias, wqkv, wo, bo, *, local_heads: int, heads: int,
              window: int, out_dtype: torch.dtype) -> torch.Tensor:
    """h (B, L, d), bias (B, d) in h's dtype, wqkv (d, 3d) → (B, L, d)."""
    B, L, d = h.shape
    xb, xn = bias_layernorm(h, bias, ln_scale, ln_bias, eps=LN_EPS)
    qkv = gemm_bias_act(xn.view(B * L, d), wqkv).view(B, L, 3 * d)
    att = stage3_attention_core(qkv, heads=heads, local_heads=local_heads, window=window)
    out = gemm_bias_act(att.view(B * L, d), wo, bo, residual=xb.view(B * L, d),
                        out_dtype=out_dtype)
    return out.view(B, L, d)


def ff_half(x, ln_scale, ln_bias, w1, b1, w2, b2, *, gelu: str, cdtype: torch.dtype,
            out_dtype: torch.dtype) -> torch.Tensor:
    """x (B, L, d) in f32 or ``cdtype`` → x + FF(LN(x)) in ``out_dtype``."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    xn = layernorm(x2, ln_scale, ln_bias, eps=LN_EPS, out_dtype=cdtype)
    mid = gemm_bias_act(xn, w1, b1, act=gelu)
    return gemm_bias_act(mid, w2, b2, residual=x2, out_dtype=out_dtype).view(x.shape)


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
