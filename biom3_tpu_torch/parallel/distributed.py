"""The process group and the training mesh: one process per rank.

Port of ``biom3_tpu/parallel/distributed.py:20-52``.  JAX starts one
process per host and sees every device of the cluster; here every rank is
a process of its own, on one card, in a ``torch.distributed`` group:
NCCL between cards, gloo on the CPU when the caller asks for it (the CPU
tests).  ``make_hybrid_mesh`` lays the ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` with the dims ``("dp",
"fsdp", "tp")``: ranks are numbered host-major (as ``torchrun`` numbers
them), so dp runs across hosts and each (fsdp, tp) block lies inside one
host, the layout JAX's ``create_hybrid_device_mesh`` builds.

This mesh is not ``parallel/mesh.Mesh``: that one is a single process
driving a grid of device positions (serving, sweeps); this one is the
group of training processes, each holding its shard of the parameters
(``parallel/sharding.shard_params``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from biom3_tpu_torch.parallel.mesh import AXES, MeshConfig
from biom3_tpu_torch.pipeline import require_device


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           *, device="cuda", backend: str | None = None) -> torch.device:
    """Join the process group → this rank's device.

    ``coordinator_address``: ``tcp://host:port`` of rank 0, with
    ``num_processes`` and ``process_id``; without it the group comes from
    the environment ``torchrun`` sets (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the counterpart of JAX's
    auto-detection on pods.  ``device="cuda"`` (the default) uses NCCL and
    the card ``LOCAL_RANK`` names (else ``process_id`` modulo the cards),
    and raises without a card; ``device="cpu"`` uses gloo.  ``backend=
    "gloo"`` with ``device="cuda"`` runs gloo over CUDA tensors, which lets
    several ranks share one card (NCCL refuses two ranks on one card);
    DTensor's own redistribution does not run on such a group, the
    ``torch.distributed`` collectives do."""
    device = torch.device(device)
    require_device(device, "initialize_distributed")
    kw = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        kw = dict(init_method=coordinator_address, world_size=num_processes, rank=process_id)
    if backend not in (None, "nccl", "gloo") or (device.type == "cpu" and backend == "nccl"):
        raise ValueError(f"backend {backend!r} on {device.type}")
    if device.type == "cpu":
        dist.init_process_group("gloo", **kw)
        return device
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    if backend == "gloo":
        dist.init_process_group("gloo", **kw)
    else:
        dist.init_process_group("nccl", device_id=device, **kw)
    return device


def make_hybrid_mesh(cfg: MeshConfig, *, ranks_per_host: int | None = None,
                     device_type: str | None = None):
    """A ``DeviceMesh`` of the group's ranks, shaped (dp, fsdp, tp), rank
    ``r`` at ``(r // (fsdp·tp), (r // tp) % fsdp, r % tp)``.  The world size
    must be dp·fsdp·tp.  ``ranks_per_host`` (default: ``LOCAL_WORLD_SIZE``
    where ``torchrun`` sets it) must be a multiple of fsdp·tp, so that no
    (fsdp, tp) block spans two hosts.  ``device_type``: the ranks' devices,
    by default ``"cuda"`` on NCCL and ``"cpu"`` on gloo (``"cuda"`` for a
    gloo group over CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    if ranks_per_host is None and "LOCAL_WORLD_SIZE" in os.environ:
        ranks_per_host = int(os.environ["LOCAL_WORLD_SIZE"])
    block = cfg.fsdp * cfg.tp
    if ranks_per_host is not None and ranks_per_host % block:
        raise ValueError(f"an (fsdp, tp) block of {block} ranks would span hosts of "
                         f"{ranks_per_host} ranks")
    world = dist.get_world_size()
    if world != cfg.num_devices:
        raise ValueError(f"mesh dp={cfg.dp} x fsdp={cfg.fsdp} x tp={cfg.tp} needs "
                         f"{cfg.num_devices} ranks, the group has {world}")
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (cfg.dp, cfg.fsdp, cfg.tp), mesh_dim_names=AXES)
