"""Full softmax attention of the Stage-1 towers' graph path.

Port of ``biom3_tpu/ops/attention.py:16-74``: f32 scores and softmax, PAD
keys at -1e9, probabilities rounded to v's dtype before the value product.
``impl="plain"`` is the JAX package's ``impl="xla"``; ``impl="kernel"`` is
its ``impl="pallas:…"``, the ``flash_attention`` kernel (on a CPU tensor
its wrapper runs the same plain math).  ``impl="ring"`` is not ported
(ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import flash_attention, flash_attention_plain

IMPLS = ("plain", "kernel")


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   padding_mask: torch.Tensor | None = None, *,
                   impl: str = "plain") -> torch.Tensor:
    """q, k, v (B, H, L, D); padding_mask (B, L), True at PAD → (B, H, L, D)."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    mask = None if padding_mask is None else padding_mask.to(torch.int32).contiguous()
    if impl == "kernel":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    return flash_attention_plain(q, k, v, mask)
