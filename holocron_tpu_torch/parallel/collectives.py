"""Collectives named by mesh axis: the port of ``holocron_tpu/parallel/collectives.py``.

Each runs on the process group of one dimension of a mesh (``mesh.get_group(axis)``,
a mesh of :func:`~holocron_tpu_torch.parallel.create_mesh`); without a mesh the ``data``
axis is the default group, every process. Gradients flow through them as
through their JAX counterparts under ``shard_map``: every process backpropagates its
own loss, and the backward of a sum over processes sums the gradients over them
(``psum``), of a gather scatters them (``all_gather``), of a permutation applies the
inverse one (``ppermute``). (The autograd functions are written here:
``torch.distributed.nn.functional`` is deprecated from torch 2.13.)
"""

from typing import Sequence, Tuple

import torch
from torch import distributed as dist

__all__ = ["all_gather", "axis_index", "axis_size", "pmean", "ppermute", "psum", "reduce_scatter"]


def _group(axis_name: str, mesh=None):
    if mesh is not None:
        return mesh.get_group(axis_name)
    if axis_name != "data":
        raise ValueError(f"no mesh was given to name the axis {axis_name!r}")
    return dist.group.WORLD


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    chunks = [c.contiguous() for c in x.chunk(dist.get_world_size(group), dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _Scatter.apply(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.group, ctx.dim), None, None


def _permute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """Sends ``x`` along each ``(source, destination)`` pair of group ranks; a rank that
    no pair reaches gets zeros (``lax.ppermute``)."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _Permute.apply(g, [(dst, src) for src, dst in ctx.perm], ctx.group), None, None


def psum(x: torch.Tensor, axis_name: str = "data", mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``axis_name``."""
    return _Sum.apply(x, _group(axis_name, mesh))


def pmean(x: torch.Tensor, axis_name: str = "data", mesh=None) -> torch.Tensor:
    """The mean of ``x`` over the processes of ``axis_name``."""
    return psum(x, axis_name, mesh) / axis_size(axis_name, mesh)


def all_gather(x: torch.Tensor, axis_name: str = "data", axis: int = 0, tiled: bool = True,
               mesh=None) -> torch.Tensor:
    """Every process's ``x`` in rank order: concatenated along ``axis`` (``tiled``) or
    stacked on a new ``axis``."""
    group = _group(axis_name, mesh)
    if tiled:
        return _Gather.apply(x, group, axis)
    return _Gather.apply(x.unsqueeze(axis), group, axis)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], axis_name: str = "data",
             mesh=None) -> torch.Tensor:
    """``x`` sent along the ``(source, destination)`` pairs of axis indices of ``perm``
    (``batch_isend_irecv``); zeros where no pair arrives."""
    return _Permute.apply(x, [tuple(p) for p in perm], _group(axis_name, mesh))


def reduce_scatter(x: torch.Tensor, axis_name: str = "data", scatter_dimension: int = 0,
                   mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``axis_name``, each keeping its own block
    of ``scatter_dimension`` (tiled: the blocks are equal, in rank order)."""
    return _Scatter.apply(x, _group(axis_name, mesh), scatter_dimension)


def axis_index(axis_name: str = "data", mesh=None) -> int:
    """This process's index along ``axis_name``."""
    return dist.get_rank(_group(axis_name, mesh))


def axis_size(axis_name: str = "data", mesh=None) -> int:
    """The processes along ``axis_name``."""
    return dist.get_world_size(_group(axis_name, mesh))
