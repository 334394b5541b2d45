"""Data, tensor and spatial parallelism across processes (``holocron_tpu/parallel``) on
``torch.distributed``, one process a device: the process group and meshes
(``multihost.py``, ``mesh.py``), the named collectives, the cross-process batch norm,
tensor parallelism (``inference.py``) and spatial partitioning (``spatial.py``), both
run by the split-tensor mode of ``sharded.py``, and the GPipe schedule over a stack of
identical blocks (``pipeline.py``), one stage a process."""

from . import collectives
from .batchnorm import CrossProcessBatchNorm2d, CrossProcessFlaxBatchNorm2d, convert_batchnorm
from .inference import shard_inference, tensor_parallel_specs
from .mesh import batch_sharding, create_mesh, replicated, shard_batch
from .multihost import host_local_put, hybrid_mesh, initialize, local_device, num_slices, rank, replicate_to_host, \
    world_size
from .pipeline import pipeline_blocks, pipeline_module, stack_stage_variables, stage_variables
from .spatial import shard_spatial_inference, spatial_sharding

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
    "pipeline_blocks",
    "pipeline_module",
    "rank",
    "replicate_to_host",
    "replicated",
    "shard_batch",
    "shard_inference",
    "shard_spatial_inference",
    "spatial_sharding",
    "stack_stage_variables",
    "stage_variables",
    "tensor_parallel_specs",
    "world_size",
]
