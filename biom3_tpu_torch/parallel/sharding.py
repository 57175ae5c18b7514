"""Batch rows over a mesh's (dp, fsdp) positions.

The port's counterpart of the JAX package's batch sharding
(``biom3_tpu/parallel/sharding.py``: ``P(("dp", "fsdp"))``) and of the
``shard_map`` bodies that run one forward per device with the parameters
replicated (``models/fused_forward.py:294-318``).  Batch shard ``s = i·fsdp
+ j`` takes the contiguous rows ``[s·B/n, (s+1)·B/n)``; under tp > 1 each
(dp, fsdp) row block runs once, at its tp = 0 position (in JAX the tp
positions compute the same rows).

``shard_rows`` issues each position's work on its own device without a
host sync: inputs and outputs move with ``non_blocking`` copies and
nothing is read back, so positions on distinct cards run at once, while
positions that share a card run one after another on its current stream.
Randomness stays with the caller, on the global batch: only the forward
is split.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from biom3_tpu_torch.parallel.mesh import Mesh, canonical


def device_context(device: torch.device):
    """Make ``device`` current for a kernel launch (the wrappers launch on
    the current device's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def split_rows(t: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """``n`` contiguous row blocks of ``t`` (views), in shard order."""
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} not divisible by {n} mesh shards")
    return t.split(t.shape[0] // n)


def gather_rows(parts, device: torch.device):
    """Concatenate the shards' outputs (tensors, or tuples of tensors) in
    shard order on ``device``."""
    if isinstance(parts[0], tuple):
        return tuple(gather_rows([p[i] for p in parts], device) for i in range(len(parts[0])))
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def module_on(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` itself where it lies on ``device``, else a copy there."""
    here = canonical(next(module.parameters()).device)
    return module if here == device else copy.deepcopy(module).to(device)


def moved_to(tree, device: torch.device):
    """A copy of ``tree`` (tensors in dicts, lists and tuples) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: moved_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(moved_to(v, device) for v in tree)
    return tree


def per_position(mesh: Mesh, make) -> list:
    """``make(device)`` once per DISTINCT device of the batch positions →
    one object per position; positions on one device share it."""
    made: dict[torch.device, object] = {}
    for device in mesh.batch_devices():
        if device not in made:
            made[device] = make(device)
    return [made[d] for d in mesh.batch_devices()]


def shard_rows(fns: list, mesh: Mesh):
    """``fns[s]``, batch position s's function of row tensors, → one
    function of global tensors: each tensor argument (any other passes
    through) is split into the positions' row blocks, each block runs at
    its position on its device, and the outputs are gathered onto the
    mesh's first device.  The batch must divide by dp·fsdp; the returned
    function carries ``.mesh``."""
    devices = mesh.batch_devices()
    n, first = len(devices), mesh.first_device
    if len(fns) != n:
        raise ValueError(f"{len(fns)} functions for {n} batch positions")

    def sharded(*args):
        parts = [split_rows(a, n) if isinstance(a, torch.Tensor) else (a,) * n for a in args]
        outs = []
        for s, (device, fn) in enumerate(zip(devices, fns)):
            with device_context(device):
                outs.append(fn(*(p[s].to(device, non_blocking=True)
                                 if isinstance(p[s], torch.Tensor) else p[s] for p in parts)))
        return gather_rows(outs, first)

    sharded.mesh = mesh
    return sharded
