"""Read/write PyTorch ``.pt``/``.bin``/``.ckpt`` files as numpy pytrees.

The port's copy of ``biom3_tpu/io/torch_load.py:16-74``.  The reference
pipeline moves data between stages through ``torch.save``d dict files and
distributes checkpoints as ``.bin`` state dicts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_numpy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        converted = [_to_numpy(v) for v in obj]
        return type(obj)(converted) if isinstance(obj, tuple) else converted
    return obj


def load_torch_file(path: str, *, numpy: bool = True) -> Any:
    """Load a torch-serialized file; tensors become numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return _to_numpy(obj) if numpy else obj


def save_torch_file(obj: Any, path: str) -> None:
    """Save a pytree as a torch file (numpy arrays → tensors; tensors move
    to the host), keeping the reference CLIs' ``.pt`` output format
    readable by the reference's own downstream stages."""

    def convert(o):
        if isinstance(o, dict):
            return {k: convert(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            vals = [convert(v) for v in o]
            return vals if isinstance(o, list) else tuple(vals)
        if isinstance(o, torch.Tensor):
            return o.detach().cpu()
        if hasattr(o, "__array__") and not isinstance(o, (str, bytes)):
            # np.array copies: a read-only buffer would make torch warn
            return torch.from_numpy(np.array(o))
        return o

    torch.save(convert(obj), path)


def strip_prefix(state_dict: dict, prefix: str) -> dict:
    """Drop a leading module prefix (e.g. Lightning's ``model.``) if present."""
    if any(k.startswith(prefix) for k in state_dict):
        return {
            (k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()
        }
    return state_dict


def unwrap_checkpoint(obj: Any) -> dict:
    """Extract a flat state dict from raw state dicts or Lightning ``.ckpt``s."""
    if isinstance(obj, dict) and "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint object: {type(obj)}")
    return obj
