"""Device meshes over the process group: the port of ``holocron_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default group with
named dimensions, ``("data", "model")`` by default, one process a device; each
dimension has its process group (``mesh.get_group(name)``), on which
:mod:`~holocron_tpu_torch.parallel.collectives` runs. A sharding is the mesh and one
``DTensor`` placement a dimension.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import distributed as dist

__all__ = ["Sharding", "batch_sharding", "create_mesh", "replicated", "shard_batch"]


class Sharding(NamedTuple):
    """A mesh and the ``DTensor`` placement of each of its dimensions (the port's
    ``NamedSharding``)."""

    mesh: object
    placements: Tuple


def create_mesh(axes: Sequence[str] = ("data", "model"), model_parallel: int = 1,
                device_type: Optional[str] = None):
    """A mesh over every process of the group (``mesh.py:20-39``): ``(world /
    model_parallel, model_parallel)``, or ``(world,)`` for one axis name; the second
    axis is ``model`` for tensor parallelism or ``spatial`` for spatial partitioning
    (``("data", "spatial")``), consecutive ranks sharing a model or spatial group.
    ``device_type`` defaults to ``cuda`` under NCCL and ``cpu`` under gloo; gloo over
    CUDA tensors (processes sharing a card) asks for ``cuda``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call holocron_tpu_torch.parallel.initialize() (or torchrun) first")
    n = dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices cannot host a model-parallel factor of {model_parallel}")
    shape = (n // model_parallel, model_parallel)
    if len(axes) == 1:
        shape = (n,)
    axes = tuple(axes[: len(shape)])
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def batch_sharding(mesh, axis: str = "data") -> Sharding:
    """The leading (batch) dimension split over ``axis``, replicated over the others
    (``mesh.py:42-44``). The processes of a model or spatial group hold the same rows:
    the batch splits over the ``axis`` dimension of the mesh, one device a process."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    return Sharding(mesh, tuple(Shard(0) if name == axis else Replicate() for name in names))


def replicated(mesh) -> Sharding:
    """Every dimension replicated (``mesh.py:47-48``)."""
    from torch.distributed.tensor import Replicate

    return Sharding(mesh, (Replicate(),) * mesh.ndim)


def shard_batch(batch, mesh, axis: str = "data"):
    """A global batch (a tensor or a pytree of them, the same on every process) as
    ``DTensor`` s split over ``axis`` (``mesh.py:51-54``): each process keeps its own
    rows of its copy, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._pytree import tree_map

    sharding = batch_sharding(mesh, axis)
    device = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")
    return tree_map(lambda t: distribute_tensor(torch.as_tensor(t).to(device), mesh, sharding.placements,
                                                src_data_rank=None), batch)
