"""Device mesh of the port: a (dp, fsdp, tp) grid of positions.

Port of ``biom3_tpu/parallel/mesh.py:31-50``.  The JAX package's mesh is a
``jax.sharding.Mesh`` over which ``shard_map`` runs one program per device.
Here one process drives a grid of *positions*, each holding a
``torch.device``: a sharded call splits the batch's rows over the (dp,
fsdp) positions, runs each position's rows on its device and gathers the
outputs onto the first position's device (``parallel/sharding.py``).  The
axes keep the JAX names:

  * ``dp``   — data parallel (batch rows);
  * ``fsdp`` — a second batch axis for activations (parameter sharding
               arrives with the training path);
  * ``tp``   — the axis ring attention shards the sequence over.

``make_mesh`` takes every visible card by default.  An explicit ``devices``
list may repeat a device: positions that share one card (or the CPU) run
one after another on it — that is how the CPU tests and a one-card machine
exercise the code that spreads rows over several cards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from biom3_tpu_torch.pipeline import require_device

AXES = ("dp", "fsdp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp


def canonical(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` → ``cuda:<current>``),
    so that two names of one card compare equal."""
    device = torch.device(device)
    require_device(device, "make_mesh")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """``devices``: a (dp, fsdp, tp) numpy object array of ``torch.device``;
    ``shape``: axis name → size, as ``jax.sharding.Mesh.shape``."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"mesh devices must be a {len(AXES)}-d grid, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def batch_shards(self) -> int:
        """Positions a batch's rows split over: dp · fsdp."""
        return self.shape["dp"] * self.shape["fsdp"]

    def batch_devices(self) -> list[torch.device]:
        """The device of batch shard ``s = i·fsdp + j`` (dp index i, fsdp
        index j, tp index 0): JAX's ``P(("dp", "fsdp"))`` order."""
        return list(self.devices[:, :, 0].reshape(-1))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, the other axes at index 0."""
        if axis not in AXES:
            raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")
        index = [0] * len(AXES)
        index[AXES.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    @property
    def first_device(self) -> torch.device:
        """Where sharded calls gather their outputs and samplers draw."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        counts: dict[str, int] = {}
        for d in self.devices.flat:
            counts[str(d)] = counts.get(str(d), 0) + 1
        where = ", ".join(f"{k} x{v}" if v > 1 else k for k, v in counts.items())
        return f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}; {where})"


def make_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """A ``(dp, fsdp, tp)`` mesh over ``devices`` (default: every visible
    card, ``cuda:0 .. n-1``), filled in row-major order as JAX's."""
    if devices is None:
        require_device(torch.device("cuda"), "make_mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical(d) for d in devices]
    n = cfg.num_devices
    if len(devices) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(cfg.dp, cfg.fsdp, cfg.tp))
