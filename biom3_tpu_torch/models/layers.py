"""Flax ``dtype=`` semantics for the port's ``nn.Linear``/``nn.LayerNorm``.

A Flax ``nn.Dense(dtype=d)`` casts its input, kernel and bias to ``d``; a
Flax ``nn.LayerNorm`` with f32 parameters returns f32 whatever its input.
The training modules keep f32 master parameters and compute in ``dtype``
through these two helpers; ``dtype=None`` calls the module as it is (the
inference paths, which cast whole modules).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    if dtype is None:
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)
