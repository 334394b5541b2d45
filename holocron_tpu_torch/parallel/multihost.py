"""Processes joined into one data-parallel job: the port of
``holocron_tpu/parallel/multihost.py``.

The JAX package joins its processes with ``jax.distributed`` and lays every device of
every host on one mesh. The port runs one process a device, as ``torchrun`` launches
them, joined by ``torch.distributed``: NCCL between CUDA devices, gloo on the CPU. Each
process feeds its own shard of the batch (``EpochDataLoader(num_shards="auto")``), and
a node is the processes of one host (``torchrun``'s ``LOCAL_WORLD_SIZE``).
"""

import os
from typing import Optional, Union

import numpy as np
import torch
from torch import distributed as dist

from .mesh import create_mesh

__all__ = ["host_local_put", "hybrid_mesh", "initialize", "local_device", "num_slices", "rank", "replicate_to_host",
           "world_size"]


def world_size() -> int:
    """The processes of the job: the default group's size, 1 without a group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device``, a CUDA device without an index taking this process's own,
    ``cuda:LOCAL_RANK`` (0 when ``LOCAL_RANK`` is unset)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def initialize(device: Union[str, torch.device] = "cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> None:
    """Joins the default process group (``multihost.py:28-65``): idempotent (a joined
    group is kept), and a no-op for one process. The JAX package remembers a call that
    joined nothing, since probing its runtime would start it; ``dist.is_initialized()``
    starts nothing, so here a later call with the environment set still joins.

    The arguments default to ``torchrun``'s environment: ``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (``init_method="env://"``); ``LOCAL_RANK`` picks
    the process's card. Nothing is joined when neither ``WORLD_SIZE`` nor
    ``init_method`` is given. The backend is NCCL for a CUDA ``device``, gloo for the CPU;
    nothing falls back from one to the other.
    """
    if dist.is_initialized():
        return
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "0")) or None
    if world_size is None and init_method is None:
        return
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    device = local_device(device)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method or "env://",
                            world_size=world_size or 1, rank=rank, **kwargs)


def _mesh_device(mesh) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")


def host_local_put(data, sharding):
    """Places this process's shard of a batch (``multihost.py:68-84``): with one device a
    process, the shard goes to the local device; across processes it becomes the
    process's part of a global ``DTensor`` of ``world size`` times its rows along the
    sharded dimension. ``sharding``: :func:`~holocron_tpu_torch.parallel.batch_sharding`'s."""
    from torch.distributed.tensor import DTensor

    local = torch.as_tensor(np.asarray(data) if not isinstance(data, torch.Tensor) else data)
    local = local.to(_mesh_device(sharding.mesh))
    if world_size() > 1:
        return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False)
    return local


def replicate_to_host(leaf, mesh=None) -> np.ndarray:
    """``leaf`` as a host numpy array (``multihost.py:87-106``), a sharded ``DTensor``
    gathered whole first: a collective, which every process calls in lockstep."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def num_slices() -> int:
    """The nodes of the job (``multihost.py:109-113``): the world size over the
    processes of one node (``LOCAL_WORLD_SIZE``; 1 node without it)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0")) or world_size()
    return max(world_size() // local, 1)


# ``multihost.py:116-150``'s mesh with the data axis across nodes and the model axis inside
# one: torchrun numbers the ranks node by node, so consecutive ranks, which
# ``create_mesh`` puts in one model group, are already on one node
hybrid_mesh = create_mesh
