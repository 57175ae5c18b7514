"""Rotary position embeddings (GPT-NeoX / fair-esm style).

Port of ``biom3_tpu/ops/rotary.py:17-49``: ESM2's attention rotates the
full head dim with the half-split ``rotate_half(x) = concat(-x2, x1)`` and
cos/sin tables built from ``inv_freq = 10000^(-2i/d)``, duplicated over
both halves.  The tables are computed in f32 on the host and cast to the
working dtype; ``apply_rotary`` computes in the dtype of its inputs, so in
bf16 each product and the sum round to bf16 as the TPU kernel's do.
"""

from __future__ import annotations

import torch


def rotary_cos_sin(seq_len: int, dim: int, *, dtype: torch.dtype = torch.float32,
                   device: torch.device | str | None = None):
    """(seq_len, dim) cos and sin tables."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    t = torch.arange(seq_len, dtype=torch.float32)
    emb = torch.cat([torch.outer(t, inv_freq)] * 2, dim=-1)
    return emb.cos().to(device=device, dtype=dtype), emb.sin().to(device=device, dtype=dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., L, D); cos, sin (L, D)."""
    return x * cos + rotate_half(x) * sin
