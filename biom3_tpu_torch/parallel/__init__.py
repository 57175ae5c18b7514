"""The device meshes of the port (port of ``biom3_tpu/parallel``): one
process driving a (dp, fsdp, tp) grid of device positions for serving and
sweeps (``mesh.Mesh``, ``sharding.shard_rows``), and the training group,
one process per rank, whose parameters FSDP2 shards over (dp, fsdp) and
the layers split over tp (``distributed.make_hybrid_mesh``,
``sharding.shard_params``, ``tensor``)."""

from biom3_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh, param_partition_spec
from biom3_tpu_torch.parallel.sharding import (
    gather_rows,
    params_shardings,
    put_global,
    shard_params,
    shard_rows,
    split_rows,
)

__all__ = ["Mesh", "MeshConfig", "make_mesh", "param_partition_spec", "gather_rows",
           "params_shardings", "put_global", "shard_params", "shard_rows", "split_rows"]
