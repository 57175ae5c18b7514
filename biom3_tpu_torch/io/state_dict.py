"""Reference state dicts in and out of the port's modules.

The port's modules carry the reference checkpoints' parameter names, so a
published ``.bin`` loads with ``load_state_dict(strict=True)``; the helpers
here only unwrap Lightning's ``state_dict``/``model.`` wrapping and turn
numpy arrays into tensors.  ``seeded_init_`` gives a module reproducible
random weights from a seed (no global RNG).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from biom3_tpu_torch.io.torch_io import load_torch_file, strip_prefix, unwrap_checkpoint


def to_tensors(sd: dict) -> dict[str, torch.Tensor]:
    """numpy (or tensor) values → f32 CPU tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.bin``/``.pt``/``.ckpt`` → flat state dict of tensors."""
    return to_tensors(strip_prefix(unwrap_checkpoint(load_torch_file(path)), "model."))


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``: matrices and tables N(0, 1/fan_in),
    LayerNorm scales 1 + N(0, 0.1²), biases N(0, 0.02²); a weight-norm gain
    is set to its direction's norm, so the effective weight is ``weight_v``."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight_g":
            continue
        noise = torch.randn(p.shape, generator=g)
        if p.dim() >= 2:
            p.copy_(noise * p.shape[-1] ** -0.5)
        elif leaf == "weight":
            p.copy_(1.0 + 0.1 * noise)
        else:
            p.copy_(0.02 * noise)
    for name, p in module.named_parameters():
        if name.endswith("weight_g"):
            p.copy_(module.get_parameter(name[: -len("weight_g")] + "weight_v").norm())
    return module
