"""Stage-2 Facilitator: weight-normalised MLP z_t → z_c.

Port of ``biom3_tpu/models/facilitator.py:25-64``:
weight_norm(Linear(in, hid), dim=None) → exact GELU → Dropout →
weight_norm(Linear(hid, out), dim=None), with W = g·V/‖V‖_F over the whole
matrix (one scalar gain).  Parameter names are the published ``.bin``'s
(``main.{0,3}.weight_g``, ``weight_v``, ``bias``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from biom3_tpu_torch.config import FacilitatorConfig


class WeightNormLinear(nn.Module):
    """``weight_norm(nn.Linear, dim=None)``: scalar gain ``weight_g``,
    direction ``weight_v`` (out, in), bias."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim))
        nn.init.kaiming_uniform_(self.weight_v, a=5 ** 0.5)
        self.weight_g = nn.Parameter(self.weight_v.detach().norm())
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_v * (self.weight_g / self.weight_v.norm())
        return F.linear(x, w, self.bias)


class Facilitator(nn.Module):
    """z_t (B, in_dim) → z_c (B, out_dim)."""

    def __init__(self, cfg: FacilitatorConfig):
        super().__init__()
        self.config = cfg
        self.main = nn.Sequential(WeightNormLinear(cfg.in_dim, cfg.hid_dim), nn.GELU(),
                                  nn.Dropout(cfg.dropout),
                                  WeightNormLinear(cfg.hid_dim, cfg.out_dim))

    def forward(self, z_t: torch.Tensor) -> torch.Tensor:
        return self.main(z_t)
