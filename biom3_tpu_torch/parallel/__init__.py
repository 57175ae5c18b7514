"""The device mesh and batch sharding of the serving and sweep paths
(port of ``biom3_tpu/parallel``).  Parameter placement over fsdp/tp and the
multi-process group arrive with the training path."""

from biom3_tpu_torch.parallel.mesh import Mesh, MeshConfig, make_mesh
from biom3_tpu_torch.parallel.sharding import gather_rows, shard_rows, split_rows

__all__ = ["Mesh", "MeshConfig", "make_mesh", "gather_rows", "shard_rows", "split_rows"]
