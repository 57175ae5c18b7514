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
  * ``tp``   — the axis ring attention shards the sequence over (in
               training, the Megatron axis: ``parallel/tensor.py``).

``make_mesh`` takes every visible card by default.  An explicit ``devices``
list may repeat a device: positions that share one card (or the CPU) run
one after another on it — that is how the CPU tests and a one-card machine
exercise the code that spreads rows over several cards.

This mesh is for one process.  Training runs one process per rank on a
``torch.distributed`` group instead, over the ``DeviceMesh`` that
``parallel/distributed.make_hybrid_mesh`` builds; ``param_partition_spec``
below gives its parameter placement.
"""

from __future__ import annotations

import dataclasses
import re

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


# Parameter placement (JAX ``parallel/mesh.py:53-93``), on the port's
# parameter names.  A torch ``Linear.weight`` is (out, in) where a Flax
# kernel is (in, out): a column-parallel weight takes tp on dim 0 and fsdp
# on dim 1, a row-parallel one the reverse; an embedding table keeps its
# vocab dim 0 in both.  The names are those the JAX rules match, spelled
# as the port spells them: JAX's row-parallel ``to_out``, ``ff_w2``,
# ``fc2`` (the conditioning MLPs' second layer too), ``out_proj``
# (ProteoScribe's head too) are ``to_out``, ``fn.w2``, ``fc2``,
# ``mlp.2``, ``out_proj`` and ``transformer.out`` here; everything else
# 2-D is column-parallel, as in JAX.
_ROW_PARALLEL = re.compile(r"(to_out|fn\.w2\.|fc2|mlp\.2\.|out_proj|o_proj|^transformer\.out\.)")
_EMBEDDING = re.compile(r"(x_emb_NN|embed_tokens|_embeddings)\.weight$")


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name → size of a ``MeshConfig``, a ``Mesh`` or a
    ``torch.distributed`` ``DeviceMesh`` with named dims."""
    if isinstance(mesh, MeshConfig):
        return {"dp": mesh.dp, "fsdp": mesh.fsdp, "tp": mesh.tp}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def param_partition_spec(name: str, shape: tuple, mesh) -> tuple:
    """The mesh axis (``"fsdp"``, ``"tp"`` or None) of each dim of the
    parameter ``name`` of ``shape``, as JAX's ``PartitionSpec``: ``()``
    replicates.  1-D parameters replicate; an axis goes only on a dim it
    divides, else that dim replicates.  The axial position tables, (R, d)
    in JAX and (1, R, 1, d) / (1, 1, W, d) here, are not transposed: their
    two non-singleton dims take JAX's (fsdp, tp)."""
    sizes = axis_sizes(mesh)
    fsdp_n, tp_n = sizes["fsdp"], sizes["tp"]

    def fits(dim: int, n: int) -> bool:
        return n > 1 and dim % n == 0

    if len(shape) < 2:
        return ()
    if len(shape) > 2:
        spec = [None] * len(shape)
        dims = [i for i, n in enumerate(shape) if n != 1]
        if len(dims) == 2:
            r, c = dims
            spec[r] = "fsdp" if fits(shape[r], fsdp_n) else None
            spec[c] = "tp" if fits(shape[c], tp_n) else None
        elif fits(shape[-1], tp_n):
            spec[-1] = "tp"
        return tuple(spec)
    if _EMBEDDING.search(name):
        return ("fsdp" if fits(shape[0], fsdp_n) else None, None)
    if _ROW_PARALLEL.search(name):
        return ("fsdp" if fits(shape[0], fsdp_n) else None,
                "tp" if fits(shape[1], tp_n) else None)
    return ("tp" if fits(shape[0], tp_n) else None,
            "fsdp" if fits(shape[1], fsdp_n) else None)


def fsdp_dim(spec: tuple) -> int | None:
    """The dim a spec shards over fsdp, or None."""
    return spec.index("fsdp") if "fsdp" in spec else None
