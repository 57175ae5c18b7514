"""Non-causal linear attention — plain PyTorch.

Port of ``biom3_tpu/ops/linear_attention.py:22-50`` (lucidrains
``linear_attn``): q' = softmax(q over features)·D^-0.5, k' = softmax(k over
the sequence), out = q' (k'ᵀ v).  Softmaxes in f32; q', k' and the context
are cast to v's dtype before their products, as the reference does in bf16.
"""

from __future__ import annotations

import torch


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (..., L, D) → (..., L, D)."""
    dtype = v.dtype
    qf = (torch.softmax(q.float(), dim=-1) * q.shape[-1] ** -0.5).to(dtype).float()
    kf = torch.softmax(k.float(), dim=-2).to(dtype).float()
    context = (kf.transpose(-1, -2) @ v.float()).to(dtype).float()
    return (qf @ context).to(dtype)
