"""Collectives named by mesh axis: the port of ``holocron_tpu/parallel/collectives.py``.

Each runs on the process group of one dimension of a mesh (``mesh.get_group(axis)``,
a mesh of :func:`~holocron_tpu_torch.parallel.create_mesh`); without a mesh the ``data``
axis is the default group, every process. Gradients flow through them as
through their JAX counterparts under ``shard_map``: every process backpropagates its
own loss, and the backward of a sum over processes sums the gradients over them
(``psum``), of a gather scatters them (``all_gather``), of a permutation applies the
inverse one (``ppermute``). (The autograd functions are written here:
``torch.distributed.nn.functional`` is deprecated from torch 2.13.)

Tensor and spatial parallelism (:mod:`~holocron_tpu_torch.parallel.sharded`) add three:

- :func:`gather_replicated`, a channel all-gather whose backward is the local slice of
  the gradient. After a column-parallel layer the downstream is replicated on every
  rank of the group and each rank's gradient of it is already the whole one, so the
  backward of :func:`all_gather` (a reduce-scatter) would make every sharded gradient
  the group's size times too large. Its converse, :func:`split_replicated`, keeps this
  rank's slice of a replicated tensor and all-gathers the gradient.
- :func:`fetch_rows`, the halo exchange: each rank receives the rows of a tensor split
  along one dimension that it needs from the ranks that own them (point to point), and
  the backward sends those rows' gradients back and adds them into the owners' rows.

gloo takes CUDA tensors for its all-reduce, all-gather, broadcast and reduce-scatter
but not for point-to-point sends (its TCP transport writes from the device pointer and
fails): under gloo, and under gloo only, those go through host memory (a copy each
way), counted in :data:`STAGED_BYTES`. NCCL takes every one on the device.
"""

from typing import Sequence, Tuple

import torch
from torch import distributed as dist

__all__ = ["STAGED_BYTES", "all_gather", "axis_index", "axis_size", "fetch_rows", "gather_replicated", "pmean",
           "ppermute", "psum", "reduce_scatter", "split_replicated", "to_parallel"]

STAGED_BYTES = [0]  # bytes that gloo collectives of CUDA tensors copied through host memory



def _to_host(t: torch.Tensor) -> torch.Tensor:
    STAGED_BYTES[0] += t.numel() * t.element_size()
    return t.cpu()


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
    sends, recvs, own = {}, {}, False
    for src, dst in perm:
        if src == me and dst == me:
            own = True
        elif src == me:
            sends[dst] = x
        elif dst == me:
            recvs[src] = (x.shape, x.dtype)
    got = _exchange(sends, recvs, group, x.device)
    if own:
        return x.clone()
    # a permutation: at most one source reaches this rank, and its tensor is fresh
    return next(iter(got.values())) if got else torch.zeros_like(x)


def _exchange(sends, recvs, group, device: torch.device):
    """Point to point in one batch: ``sends`` maps group ranks to the tensors sent
    there, ``recvs`` group ranks to the ``(shape, dtype)`` received from there; returns
    ``{source: tensor}`` on ``device``. Under gloo a CUDA tensor goes through host memory."""
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    ops, got = [], {}
    for src, (shape, dtype) in sorted(recvs.items()):
        got[src] = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
        ops.append(dist.P2POp(dist.irecv, got[src], dist.get_global_rank(group, src), group))
    for dst, t in sorted(sends.items()):
        t = _to_host(t.contiguous()) if staged else t.contiguous()
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        for t in got.values():
            STAGED_BYTES[0] += t.numel() * t.element_size()
        return {src: t.to(device) for src, t in got.items()}
    return got


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _Permute.apply(g, [(dst, src) for src, dst in ctx.perm], ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` of equal blocks; the backward keeps this rank's block of
    the gradient (the downstream is replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.size, ctx.size), None, None


class _SplitReplicated(torch.autograd.Function):
    """This rank's block along ``dim`` of a replicated tensor; the backward all-gathers
    the gradient, so that every rank holds the whole of it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        size = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g, ctx.group, ctx.dim), None, None


class _SumReplicated(torch.autograd.Function):
    """The sum over the group, whose backward passes the gradient as it is (the
    downstream is replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToParallel(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the group: the input of a
    column-parallel layer, each rank's gradient of it coming through its own block of
    the outputs only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather_uneven(x: torch.Tensor, group, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """Every rank's block along ``dim``, of ``sizes[rank]`` each, concatenated in rank
    order (blocks padded to the longest for the all-gather)."""
    longest = max(sizes)
    if x.shape[dim] < longest:
        pad = list(x.shape)
        pad[dim] = longest - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim)


class _GatherRows(torch.autograd.Function):
    """All-gather of blocks of ``sizes`` along ``dim``; the backward sums the gradient
    over the group and keeps this rank's rows (the backward of :func:`all_gather`, for
    blocks of unequal length)."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        return _gather_uneven(x, group, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, sum(ctx.sizes[:me]), ctx.sizes[me]), None, None, None


def _overlap(a: int, b: int, lo: int, hi: int) -> Tuple[int, int]:
    return max(a, lo), min(b, hi)


class _FetchRows(torch.autograd.Function):
    """The row ranges ``needed[me]`` of a tensor split along ``dim`` (rank ``r`` holding
    global rows ``owned[r]``), concatenated in their order, assembled from the ranks
    that hold them: one message each way between two ranks, the pieces of every range
    in order."""

    @staticmethod
    def forward(ctx, x, group, dim, owned, needed):
        me = dist.get_rank(group)
        own_lo, own_hi = owned[me]
        sends, recvs = {}, {}
        for r in range(len(owned)):
            if r == me:
                continue
            mine = [_overlap(a, b, own_lo, own_hi) for a, b in needed[r]]
            mine = [x.narrow(dim, s - own_lo, e - s) for s, e in mine if e > s]
            if mine:  # rows of mine that rank r needs
                sends[r] = torch.cat(mine, dim) if len(mine) > 1 else mine[0]
            rows = sum(max(0, e - s) for s, e in (_overlap(a, b, *owned[r]) for a, b in needed[me]))
            if rows:  # rows of rank r's that I need
                shape = list(x.shape)
                shape[dim] = rows
                recvs[r] = (torch.Size(shape), x.dtype)
        got = _exchange(sends, recvs, group, x.device)
        shape = list(x.shape)
        shape[dim] = sum(b - a for a, b in needed[me])
        out = x.new_empty(shape)
        taken = {r: 0 for r in got}
        offset = 0
        for a, b in needed[me]:
            for r, (lo, hi) in enumerate(owned):
                s, e = _overlap(a, b, lo, hi)
                if e <= s:
                    continue
                if r == me:
                    piece = x.narrow(dim, s - own_lo, e - s)
                else:
                    piece = got[r].narrow(dim, taken[r], e - s)
                    taken[r] += e - s
                out.narrow(dim, offset + s - a, e - s).copy_(piece)
            offset += b - a
        if any(b - a != sum(max(0, min(b, hi) - max(a, lo)) for lo, hi in owned) for a, b in needed[me]):
            raise RuntimeError(f"rows {needed[me]} are not all held by the group: {owned}")
        ctx.group, ctx.dim, ctx.owned, ctx.needed, ctx.local = group, dim, owned, needed, x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        group, dim, owned, needed = ctx.group, ctx.dim, ctx.owned, ctx.needed
        me = dist.get_rank(group)
        own_lo, own_hi = owned[me]
        grad = g.new_zeros(ctx.local)
        back = {r: [] for r in range(len(owned)) if r != me}
        offset = 0
        for a, b in needed[me]:  # each used row's gradient: to my rows, or back to its owner
            for r, (lo, hi) in enumerate(owned):
                s, e = _overlap(a, b, lo, hi)
                if e <= s:
                    continue
                piece = g.narrow(dim, offset + s - a, e - s)
                if r == me:
                    grad.narrow(dim, s - own_lo, e - s).add_(piece)
                else:
                    back[r].append(piece)
            offset += b - a
        sends = {r: torch.cat(p, dim) if len(p) > 1 else p[0] for r, p in back.items() if p}
        recvs = {}
        for r in back:
            rows = sum(max(0, e - s) for s, e in (_overlap(a, b, own_lo, own_hi) for a, b in needed[r]))
            if rows:
                shape = list(ctx.local)
                shape[dim] = rows
                recvs[r] = (torch.Size(shape), g.dtype)
        got = _exchange(sends, recvs, group, g.device)
        for r, t in got.items():
            taken = 0
            for a, b in needed[r]:
                s, e = _overlap(a, b, own_lo, own_hi)
                if e > s:
                    grad.narrow(dim, s - own_lo, e - s).add_(t.narrow(dim, taken, e - s))
                    taken += e - s
        return grad, None, None, None, None


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of every rank of ``group`` along ``dim``, concatenated: a replicated
    tensor whose gradient is each rank's own block (see the module docstring)."""
    return _GatherReplicated.apply(x, group, dim)


def to_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the whole input of a column-parallel layer over ``group``: the identity,
    its gradient summed over the group."""
    return _ToParallel.apply(x, group)


def split_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor replicated over ``group``; the
    gradient comes back whole on every rank."""
    return _SplitReplicated.apply(x, group, dim)


def fetch_rows(x: torch.Tensor, group, dim: int, owned: Sequence[Tuple[int, int]], needed) -> torch.Tensor:
    """The halo exchange: ``owned[r]`` are the global rows along ``dim`` that rank ``r``
    of ``group`` holds (``x`` holds this rank's), ``needed[r]`` the range, or the list of
    ranges, it needs (within the tensor); returns this rank's needed rows, its ranges
    concatenated. The backward sends each received row's gradient back to its owner,
    which adds it into its own. Every rank calls it with the same ``owned`` and
    ``needed``."""
    needed = [[tuple(n)] if isinstance(n[0], int) else [tuple(r) for r in n] for n in needed]
    return _FetchRows.apply(x, group, dim, [tuple(o) for o in owned], needed)


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
