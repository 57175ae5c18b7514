"""The inference engines: ``stage1.PenCLEngine``, ``stage2.FacilitatorEngine``
and ``stage3.ProteoScribeEngine``.  Each runs on the card (``device="cuda"``)
unless the caller asks for the CPU, as the JAX engines run on the first
accelerator."""

from __future__ import annotations

import torch


def require_device(device: torch.device, engine: str) -> None:
    """Raise when ``device`` is a CUDA device and no card is available: an
    engine never carries on on the CPU by itself."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{engine}: device {str(device)!r} but no CUDA device is available; "
                           f"pass device=\"cpu\" to run on the CPU")
