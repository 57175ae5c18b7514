"""Full softmax attention of the Stage-1 towers' graph path.

Port of ``biom3_tpu/ops/attention.py:16-74``: f32 scores and softmax, PAD
keys at -1e9, probabilities rounded to v's dtype before the value product.
``impl="plain"`` is the JAX package's ``impl="xla"``; ``impl="kernel"`` is
its ``impl="pallas:…"``, the ``flash_attention`` kernel (on a CPU tensor
its wrapper runs the same plain math).  ``impl="ring"`` is
``ops/ring_attention.py`` over ``mesh`` (JAX :54-60): its ``tp`` axis.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import flash_attention, flash_attention_plain
from biom3_tpu_torch.ops.ring_attention import ring_attention

IMPLS = ("plain", "kernel", "ring")


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   padding_mask: torch.Tensor | None = None, *,
                   impl: str = "plain", mesh=None) -> torch.Tensor:
    """q, k, v (B, H, L, D); padding_mask (B, L), True at PAD → (B, H, L, D)."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ring":
        if mesh is None:
            raise ValueError("impl='ring' needs a mesh")
        return ring_attention(q, k, v, mesh, axis="tp", padding_mask=padding_mask)
    mask = None if padding_mask is None else padding_mask.to(torch.int32).contiguous()
    if impl == "kernel":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    return flash_attention_plain(q, k, v, mask)
