"""Data parallelism across processes (``holocron_tpu/parallel``) on ``torch.distributed``,
one process a device. Tensor, spatial and pipeline parallelism (``inference.py``,
``spatial.py``, ``pipeline.py``) are not ported yet."""

from . import collectives
from .batchnorm import CrossProcessBatchNorm2d, CrossProcessFlaxBatchNorm2d, convert_batchnorm
from .mesh import batch_sharding, create_mesh, replicated, shard_batch
from .multihost import host_local_put, hybrid_mesh, initialize, local_device, num_slices, rank, replicate_to_host, \
    world_size

__all__ = [
    "CrossProcessBatchNorm2d",
    "CrossProcessFlaxBatchNorm2d",
    "batch_sharding",
    "collectives",
    "convert_batchnorm",
    "create_mesh",
    "host_local_put",
    "hybrid_mesh",
    "initialize",
    "local_device",
    "num_slices",
    "rank",
    "replicate_to_host",
    "replicated",
    "shard_batch",
    "world_size",
]
