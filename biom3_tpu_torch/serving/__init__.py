from biom3_tpu_torch.serving.batcher import BatcherStats, MicroBatcher
from biom3_tpu_torch.serving.continuous import ContinuousGenerateBatcher
from biom3_tpu_torch.serving.server import BioM3Server, ServingPipeline
from biom3_tpu_torch.serving.trajectory import TrajectoryBatcher

__all__ = [
    "BatcherStats",
    "BioM3Server",
    "ContinuousGenerateBatcher",
    "MicroBatcher",
    "ServingPipeline",
    "TrajectoryBatcher",
]
