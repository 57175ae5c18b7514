"""Exponential moving average of parameters.

Port of ``biom3_tpu/training/ema.py:19-29`` (the reference's
``DSEma.moving_average``): ema = β·ema + (1 − β)·param, here one
``torch._foreach_lerp_`` over all tensors, in place.  On sharded
parameters (``DTensor``s) the copies are sharded alike and each rank
updates its shards.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.training.optim import _local


def ema_init(params: list[torch.Tensor]) -> list[torch.Tensor]:
    return [p.detach().clone() for p in params]


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], params: list[torch.Tensor], beta: float = 0.9999) -> None:
    """In place: ema ← ema + (1 − β)·(param − ema)."""
    torch._foreach_lerp_([_local(e) for e in ema], [_local(p.detach()) for p in params],
                         1.0 - beta)
