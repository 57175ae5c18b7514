"""Seeded weights, and the program's engines built on them.

``seeded_state`` makes a whole state dict from ``--seed`` on the device in one
draw (``torch.randn`` on a ``torch.Generator`` of the card, in the type the
weights are served in), then scales each leaf by the rule of
``reference.common.init_rule``.  The reference reads the same tensors.

The engines take their weights only from a file path.  ``engine_loading``
hands the seeded state dict to the engine's own loader in process instead, so
that no multi-GB file is written: the engine then runs its own
``load_state_dict(strict=True)`` and its own packing, as it does for a
checkpoint.
"""

from __future__ import annotations

import contextlib
import math

import torch

from reference.common import init_rule

SEEDED = "<seeded state dict>"


def seeded_state(layout: dict[str, tuple], seed: int, device, dtype=torch.bfloat16) -> dict:
    """key → tensor of ``layout``'s shape, all from one seeded draw."""
    total = sum(math.prod(shape) for shape in layout.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in layout.items():
        n = math.prod(shape)
        mean, std = init_rule(name, shape)
        leaf = flat[at:at + n].view(shape)
        out[name] = (leaf * std + mean) if mean else leaf * std
        at += n
    for name in list(out):
        if name.endswith("weight_g"):     # weight norm: the gain is its direction's norm
            out[name] = out[name[:-len("weight_g")] + "weight_v"].float().norm().to(dtype)
    return out


@contextlib.contextmanager
def patched(obj, name: str, make):
    """Within the block, ``obj.name`` is ``make(the original)``."""
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


@contextlib.contextmanager
def engine_loading(module, state: dict):
    """Within the block, ``module``'s ``load_reference_state_dict`` returns
    ``state`` for the path ``SEEDED``."""
    def make(original):
        def load(path):
            if path != SEEDED:
                raise ValueError(f"only the seeded state is served here, not {path!r}")
            return dict(state)
        return load

    with patched(module, "load_reference_state_dict", make):
        yield SEEDED


def _device_kwargs(device) -> dict:
    """bf16 on the card (the engines' kernel path and int8 defaults); on the
    CPU the kernels' plain versions in f32 (tests)."""
    if torch.device(device).type == "cuda":
        return {"dtype": torch.bfloat16}
    return {"dtype": torch.float32, "use_stack": True}


def proteoscribe_engine(stage3: dict, state: dict, device, **kwargs):
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline import stage3 as module

    with engine_loading(module, state) as path:
        return module.ProteoScribeEngine(Config(stage3), path, device=device,
                                         **_device_kwargs(device), **kwargs)


def pencl_engine(stage1: dict, state: dict, device, **kwargs):
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline import stage1 as module

    with engine_loading(module, state) as path:
        return module.PenCLEngine(Config(stage1), path, device=device,
                                  **_device_kwargs(device), **kwargs)


def facilitator_engine(stage2: dict, state: dict, device):
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline import stage2 as module

    with engine_loading(module, state) as path:
        return module.FacilitatorEngine(Config(stage2), path, device=device)
