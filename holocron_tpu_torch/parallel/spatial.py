"""Spatial partitioning: the image height split over processes, the port of
``holocron_tpu/parallel/spatial.py``.

Each process holds and computes only its block of the rows of every activation, which
is what lets a high-resolution dense-prediction forward whose activations do not fit
one device run at all, and is the batch-1 latency path for dense prediction. The
parameters replicate. The forward runs under
:class:`~holocron_tpu_torch.parallel.sharded.SplitMode` with the input's rows split:
every windowed function (conv of any kernel, stride and padding, transposed conv, max,
average and blur pooling, bilinear and nearest resizing, padding) computes the output
rows this process owns from the input rows they need, the halo rows exchanged with the
processes that hold them; a reduction over the rows (the global pool, a mean loss) is
summed over the group; concatenations of skips split the same way at every scale join
their blocks. An H that does not divide the axis splits into blocks one row apart (the
first ``H % n`` one longer), with the one-process result, where GSPMD pads. It composes
with data parallelism on a ``("data", "spatial")`` mesh: the batch over ``data``, the
rows over ``spatial``.
"""

from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_map

from .inference import _data_block, _gather_batch, _model_device
from .mesh import Sharding, create_mesh
from .sharded import SplitMode, split_rows, tag, tree_gather

__all__ = ["shard_spatial_inference", "spatial_sharding"]


def spatial_sharding(mesh, axis: str = "spatial", batch_axis: Optional[str] = None) -> Sharding:
    """The sharding of an NCHW batch (``spatial.py:30-34``): H split over ``axis``, and
    the batch over ``batch_axis`` for a DP x SP mesh."""
    from torch.distributed.tensor import Replicate, Shard

    return Sharding(mesh, tuple(Shard(2) if a == axis else Shard(0) if a == batch_axis else Replicate()
                                for a in mesh.mesh_dim_names))


def shard_spatial_inference(
    model: torch.nn.Module,
    mesh=None,
    axis: str = "spatial",
    batch_axis: Optional[str] = None,
    gather_output: bool = True,
) -> Callable:
    """Returns ``x -> y`` running the model with the image height split over ``axis``
    (``spatial.py:37-105``).

    Args:
        model: a model in eval form, on this process's device (used as it is: the
            parameters replicate)
        mesh: defaults to a one-axis ``(axis,)`` mesh over every process
        axis: the mesh axis the height is split over
        batch_axis: also split the batch over this axis (DP x SP)
        gather_output: return the whole output on every process (the right default for
            logits and modest maps). ``False`` leaves each process its own block: its
            rows of a dense output (its batch rows too under ``batch_axis``), which
            never materialize whole anywhere.

    The callable takes the whole batch on every process (a tensor or an array, NCHW);
    H need not divide the axis. A collective: every process calls it in lockstep.
    """
    if mesh is None:
        mesh = create_mesh(axes=(axis,))
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh has no '{axis}' axis (axes: {names})")
    if batch_axis is not None and batch_axis not in names:
        raise ValueError(f"mesh has no '{batch_axis}' axis (axes: {names})")
    group = mesh.get_group(axis)
    device = _model_device(model)

    @torch.no_grad()
    def run(x):
        x = torch.as_tensor(x).to(device)
        x, blocks = _data_block(x, mesh, batch_axis)
        with SplitMode():
            y = model(split_rows(x, 2, group))
            if not gather_output:  # this process's block, as a plain tensor
                return tree_map(lambda t: tag(t, None) if isinstance(t, torch.Tensor) else t, y)
            y = tree_gather(y)
        return _gather_batch(y, blocks)

    return run
