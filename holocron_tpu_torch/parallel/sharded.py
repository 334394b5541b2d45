"""Tensors split over a process group, and the function mode that runs a model on them.

The JAX package annotates shardings and lets GSPMD place every collective. The port
places them itself, with one mechanism for every model: a tensor split along one
dimension over a group carries a :class:`Split` (its dimension, its global length, the
group), each process holding its own block of it (``bounds``: the first ``size % n``
blocks one longer); :class:`SplitMode`, a ``TorchFunctionMode``, sees every torch
function a forward calls and runs it on the blocks by a rule of the function:

- the model's code sees global shapes: ``shape``, ``size()`` and ``numel()`` of a split
  tensor are those of the whole, so its shape arithmetic (an upsampling's size, a crop,
  a reshape) is the one-process one;
- pointwise functions run on the blocks; a replicated operand of the whole length is
  sliced (rows) or the blocks are gathered (channels); reshapes, permutes, squeezes,
  concatenations and reductions over other dimensions follow the split dimension;
- a sum or mean over the split dimension is the local one summed over the group;
- everything else gathers its split arguments and runs on the whole tensors, so an
  unknown function is never wrong, only unsplit (an in-place one raises instead);
  :data:`FALLBACKS` counts these gathers by kind of split and function.

Two kinds of split, each with the gradient convention of its parallelism:

- ``"channels"`` (tensor parallelism, :mod:`~holocron_tpu_torch.parallel.inference`):
  column parallelism. A conv, linear, batch norm or int8 conv whose weights are split
  computes its block of the output channels; a dense consumer, a layer norm over the
  channels, or a join with a replicated operand gathers the blocks first
  (:func:`~holocron_tpu_torch.parallel.collectives.gather_replicated`). The loss is
  replicated and each rank's gradient of a replicated value is the whole one: the
  gather's backward is the local slice, a sum's is the identity.
- ``"rows"`` (spatial parallelism, :mod:`~holocron_tpu_torch.parallel.spatial`): every
  windowed function (conv, transposed conv, max and average pooling, bilinear and
  nearest resizing, padding, the int8 conv) computes the output rows this rank owns
  from the input rows they need, fetched from the ranks that hold them
  (:func:`~holocron_tpu_torch.parallel.collectives.fetch_rows`), rows outside the image
  padded as the function pads them. A sum over the rows is all-reduced with the
  backward of ``psum`` (it sums the gradient over the group), a gather's backward is a
  reduce-scatter: each rank's gradient is the group's size times its share, which
  averaging the gradients over every process (the data-parallel rule) divides back.
  Batch norm in training takes its statistics over the group.
"""

import contextlib
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import distributed as dist
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from . import collectives as C

__all__ = ["FALLBACKS", "Split", "SplitMode", "bounds", "gather", "local_view", "split_of", "split_rows", "tag"]

ATTR = "_hx_split"
_FULL = "_hx_full"  # a split tensor's gathered form and the version it was gathered at
STATE = "_hx_state"  # marks a model's parameters and buffers held as blocks

# Calls that ran on gathered whole tensors, by "<kind>:<function>" ("rows:conv2d"):
# a rows-split activation gathered here is held whole by every rank of its group.
FALLBACKS: Dict[str, int] = {}


def bounds(size: int, n: int, index: int) -> Tuple[int, int]:
    """The global ``[start, stop)`` of block ``index`` of ``n`` of a dimension of
    ``size``: the first ``size % n`` blocks are one longer (``torch.tensor_split``)."""
    q, r = divmod(size, n)
    start = index * q + min(index, r)
    return start, start + q + (index < r)


class Split(NamedTuple):
    """How a tensor is split: along ``dim``, of global length ``size``, over ``group``
    (``kind`` ``"rows"`` or ``"channels"``, see the module docstring)."""

    dim: int
    size: int
    group: Any
    kind: str

    @property
    def n(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def index(self) -> int:
        return dist.get_rank(self.group)

    def bounds(self, index: Optional[int] = None) -> Tuple[int, int]:
        return bounds(self.size, self.n, self.index if index is None else index)

    def all_bounds(self) -> List[Tuple[int, int]]:
        return [bounds(self.size, self.n, r) for r in range(self.n)]

    def local(self) -> int:
        lo, hi = self.bounds()
        return hi - lo

    def same(self, other: "Split") -> bool:
        return self.size == other.size and self.group is other.group and self.kind == other.kind


def split_of(t: Any) -> Optional[Split]:
    """The :class:`Split` of a tensor, None for a whole (replicated) one."""
    return t.__dict__.get(ATTR) if isinstance(t, torch.Tensor) else None


def tag(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """Marks ``t`` (this rank's block) as split by ``split``; returns ``t``."""
    if split is None:
        t.__dict__.pop(ATTR, None)
    else:
        t.__dict__[ATTR] = split
    t.__dict__.pop(_FULL, None)
    return t


def split_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of rows along ``dim`` of a whole ``x`` (the same on every rank
    of ``group``), tagged: spatial partitioning's input."""
    return local_view(x, Split(dim, x.shape[dim], group, "rows"))


def gather(t: torch.Tensor) -> torch.Tensor:
    """The whole of a split tensor (a collective over its group), differentiable with
    the convention of its kind; a whole tensor as it is."""
    split = split_of(t)
    if split is None:
        return t
    cached = t.__dict__.get(_FULL)
    if cached is not None and cached[0] == t._version:
        return cached[1]
    keep = not t.__dict__.get(STATE)  # a model's state changes in kernels that count no version
    with suspended():
        if split.kind == "channels":
            full = C.gather_replicated(t, split.group, split.dim)
        else:
            sizes = [hi - lo for lo, hi in split.all_bounds()]
            full = C._GatherRows.apply(t, split.group, split.dim, sizes)
        if keep:
            t.__dict__[_FULL] = (t._version, full)
    return full


def local_view(x: torch.Tensor, split: Split) -> torch.Tensor:
    """This rank's block of a whole ``x`` for the split ``split`` (of ``x``'s dimension
    ``split.dim``), tagged: a slice for rows, :func:`~holocron_tpu_torch.parallel.
    collectives.split_replicated` for channels."""
    with suspended():
        if split.kind == "channels":
            return tag(C.split_replicated(x, split.group, split.dim), split)
        lo, hi = split.bounds()
        return tag(x.narrow(split.dim, lo, hi - lo), split)


# ----------------------------------------------------------------------------------
# the mode
# ----------------------------------------------------------------------------------
def _has_split(args, kwargs) -> bool:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            if ATTR in a.__dict__:
                return True
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor) and ATTR in b.__dict__:
                    return True
    return False


def _name(func) -> str:
    name = getattr(func, "__name__", "")
    if name in ("__get__", "__set__"):
        return f"{getattr(getattr(func, '__self__', None), '__name__', '?')}.{name}"
    return name


def _inplace(name: str, kwargs) -> bool:
    return (name.endswith("_") and not name.endswith("__")) or (name.startswith("__i") and name != "__invert__") \
        or "out" in kwargs \
        or kwargs.get("inplace", False) is True


class SplitMode(TorchFunctionMode):
    """Runs torch functions on split tensors by the rules of this module (see the
    module docstring). Enter it around a forward whose inputs or parameters are split
    (:func:`tag`); outside it a split tensor is only this rank's block."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _has_split(args, kwargs):
            return func(*args, **kwargs)
        name = _name(func)
        rule = _RULES.get(name)
        if rule is None and name in _POINTWISE:
            rule = _pointwise
        if rule is None and name.startswith("_foreach_"):
            rule = _foreach
        if rule is None:
            rule = _fallback
        return rule(func, name, args, kwargs)


@contextlib.contextmanager
def suspended():
    """The split mode left for the block: torch functions see the local blocks."""
    with torch._C.DisableTorchFunction():
        yield


def _global_shape(t: torch.Tensor) -> torch.Size:
    split = split_of(t)
    if split is None:
        return t.shape
    shape = list(t.shape)
    shape[split.dim] = split.size
    return torch.Size(shape)


def _map_split(args, kwargs, fn):
    """``args``/``kwargs`` with each split tensor replaced by ``fn(tensor)``."""
    flat, spec = tree_flatten((args, kwargs))
    flat = [fn(a) if split_of(a) is not None else a for a in flat]
    return tree_unflatten(flat, spec)


def _fallback(func, name, args, kwargs):
    """Gathers the split arguments and runs ``func`` on the whole tensors."""
    if _inplace(name, kwargs):
        raise RuntimeError(f"{name} would write into the gathered copy of a split tensor: it has no split rule")
    for kind in {split_of(a).kind for a in tree_flatten((args, kwargs))[0] if split_of(a) is not None}:
        key = f"{kind}:{name}"
        FALLBACKS[key] = FALLBACKS.get(key, 0) + 1
    args, kwargs = _map_split(args, kwargs, gather)
    return func(*args, **kwargs)


def _tag_like(out, split: Split, rdim: int):
    """Tags each tensor of ``out`` whose dimension ``ndim - rdim`` has the local length
    of ``split``, there."""
    local = split.local()

    def one(t):
        if isinstance(t, torch.Tensor) and t.ndim >= rdim and t.shape[t.ndim - rdim] == local:
            tag(t, split._replace(dim=t.ndim - rdim))
        return t

    if isinstance(out, torch.Tensor):
        return one(out)
    if isinstance(out, (tuple, list)):
        for t in out:
            one(t)
    return out


def _one(args, kwargs) -> Tuple[torch.Tensor, Split]:
    x = args[0] if args else next(iter(kwargs.values()))
    return x, split_of(x)


# ----------------------------------------------------------------------------------
# metadata
# ----------------------------------------------------------------------------------
def _shape_get(func, name, args, kwargs):
    return _global_shape(args[0])


def _size(func, name, args, kwargs):
    shape = _global_shape(args[0])
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    return shape if dim is None else shape[dim]


def _numel(func, name, args, kwargs):
    return math.prod(_global_shape(args[0]))


def _len(func, name, args, kwargs):
    return _global_shape(args[0])[0]


def _passthrough(func, name, args, kwargs):
    return func(*args, **kwargs)


def _same_split_get(func, name, args, kwargs):
    """``.grad`` and ``.data``: the tensor of the same shape, split as its owner."""
    out = func(*args, **kwargs)
    if isinstance(out, torch.Tensor) and out.shape == args[0].shape:
        tag(out, split_of(args[0]))
    return out


# ----------------------------------------------------------------------------------
# pointwise
# ----------------------------------------------------------------------------------
_POINTWISE = set("""
add add_ sub sub_ rsub mul mul_ div div_ true_divide true_divide_ floor_divide neg neg_ __neg__ pos reciprocal
__add__ __radd__ __iadd__ __sub__ __rsub__ __isub__ __mul__ __rmul__ __imul__ __truediv__ __rtruediv__
__itruediv__ __pow__ __rpow__ __and__ __or__ __xor__ __invert__ __eq__ __ne__ __lt__ __le__ __gt__ __ge__
__abs__ relu relu_ relu6 gelu silu silu_ sigmoid sigmoid_ tanh tanh_ hardtanh hardtanh_ hardswish hardswish_
hardsigmoid hardsigmoid_ leaky_relu leaky_relu_ elu elu_ selu celu mish softplus softsign logsigmoid
exp exp_ log log_ log1p expm1 sqrt sqrt_ rsqrt rsqrt_ pow pow_ square abs abs_ sign sgn erf
clamp clamp_ clamp_min clamp_min_ clamp_max clamp_max_ clip where maximum minimum fmax fmin
eq ne lt le gt ge logical_and logical_or logical_not logical_xor bitwise_and bitwise_or bitwise_not
isfinite isnan isinf nan_to_num round round_ floor ceil trunc frac lerp lerp_ addcmul addcmul_ addcdiv addcdiv_
copy_ fill_ zero_ masked_fill masked_fill_ to type float half bfloat16 double long int bool byte char short
type_as contiguous clone detach detach_ requires_grad_ cpu cuda pin_memory
dropout dropout_ alpha_dropout feature_alpha_dropout zeros_like ones_like empty_like full_like rand_like
randn_like
""".split())


def _pointwise(func, name, args, kwargs):
    flat, spec = tree_flatten((args, kwargs))
    tensors = [a for a in flat if isinstance(a, torch.Tensor)]
    split_t = [a for a in tensors if split_of(a) is not None]
    ref = split_of(split_t[0])
    rdim = split_t[0].ndim - ref.dim  # the split dimension, counted from the right
    inplace = _inplace(name, kwargs)
    if any(not split_of(t).same(ref) or t.ndim - split_of(t).dim != rdim for t in split_t):
        return _fallback(func, name, args, kwargs)
    if inplace and split_of(args[0]) is None:
        return _fallback(func, name, args, kwargs)
    lo, hi = ref.bounds()
    out_flat = []
    for a in flat:
        if isinstance(a, torch.Tensor) and split_of(a) is None:
            pos = a.ndim - rdim
            if pos < 0 or a.shape[pos] == 1:
                if ref.kind == "channels" and a.requires_grad and not inplace:
                    # a replicated operand broadcast over the blocks would get only
                    # this block's share of its gradient: join the whole tensors
                    return _fallback(func, name, args, kwargs)
            elif a.shape[pos] == ref.size and ref.kind == "rows":
                a = a.narrow(pos, lo, hi - lo)
            else:
                return _fallback(func, name, args, kwargs)
        out_flat.append(a)
    args, kwargs = tree_unflatten(out_flat, spec)
    out = func(*args, **kwargs)
    if inplace:
        args[0].__dict__.pop(_FULL, None)
    return _tag_like(out, ref, rdim)


# ----------------------------------------------------------------------------------
# dimension bookkeeping
# ----------------------------------------------------------------------------------
def _dim(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


def _permute(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    dims = args[1:] if len(args) > 1 else kwargs.get("dims")
    if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
        dims = dims[0]
    dims = [_dim(d, x.ndim) for d in dims]
    return tag(func(*args, **kwargs), split._replace(dim=dims.index(split.dim)))


def _transpose(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    a, b = (_dim(d, x.ndim) for d in (args[1:3] if len(args) > 2 else (kwargs["dim0"], kwargs["dim1"])))
    d = b if split.dim == a else a if split.dim == b else split.dim
    return tag(func(*args, **kwargs), split._replace(dim=d))


def _movedim(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    src, dst = args[1:3] if len(args) > 2 else (kwargs["source"], kwargs["destination"])
    src = [_dim(s, x.ndim) for s in (src if isinstance(src, (list, tuple)) else [src])]
    dst = [_dim(s, x.ndim) for s in (dst if isinstance(dst, (list, tuple)) else [dst])]
    order = [d for d in range(x.ndim) if d not in src]
    for s, d in sorted(zip(dst, src)):
        order.insert(s, d)
    return tag(func(*args, **kwargs), split._replace(dim=order.index(split.dim)))


def _unsqueeze(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    k = args[1] if len(args) > 1 else kwargs["dim"]
    k = k + x.ndim + 1 if k < 0 else k
    return tag(func(*args, **kwargs), split._replace(dim=split.dim + (k <= split.dim)))


def _squeeze(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    shape = _global_shape(x)
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    if dims is None:
        dims = range(x.ndim)
    dims = [_dim(d, x.ndim) for d in (dims if isinstance(dims, (list, tuple, range)) else [dims])]
    dims = [d for d in dims if shape[d] == 1]  # by the global shape, not the block's
    with suspended():
        out = x.squeeze(tuple(dims)) if dims else x.view(x.shape)
    return tag(out, split._replace(dim=split.dim - sum(d < split.dim for d in dims)))


def _reshape_to(x: torch.Tensor, split: Split, new_shape, view: bool):
    """``x`` reshaped to the global ``new_shape``, where the split dimension survives
    whole with the same dimensions before it; else None."""
    gin = list(_global_shape(x))
    new_shape = list(new_shape)
    if -1 in new_shape:
        known = math.prod(s for s in new_shape if s != -1)
        new_shape[new_shape.index(-1)] = math.prod(gin) // max(known, 1)
    before = math.prod(gin[: split.dim])
    for j in range(len(new_shape)):
        if math.prod(new_shape[:j]) == before and new_shape[j] == split.size:
            local = list(new_shape)
            local[j] = x.shape[split.dim]
            with suspended():
                out = x.view(local) if view else x.reshape(local)
            return tag(out, split._replace(dim=j))
    return None


def _reshape(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    shape = args[1:] if len(args) > 1 else kwargs.get("shape", kwargs.get("size"))
    if len(shape) == 1 and isinstance(shape[0], (list, tuple, torch.Size)):
        shape = shape[0]
    out = _reshape_to(x, split, shape, name == "view")
    return _fallback(func, name, args, kwargs) if out is None else out


def _reshape_as(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    out = _reshape_to(x, split, _global_shape(args[1]), name == "view_as") if split is not None else None
    return _fallback(func, name, args, kwargs) if out is None else out


def _flatten(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    start = args[1] if len(args) > 1 else kwargs.get("start_dim", 0)
    end = args[2] if len(args) > 2 else kwargs.get("end_dim", -1)
    start, end = _dim(start, x.ndim), _dim(end, x.ndim)
    if split is None or start >= end:
        return _fallback(func, name, args, kwargs) if split is None else _passthrough(func, name, args, kwargs)
    shape = list(_global_shape(x))
    return _reshape(func, "reshape", (x, shape[:start] + [-1] + shape[end + 1:]), {})


def _expand(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    sizes = args[1:] if len(args) > 1 else kwargs["size"]
    if len(sizes) == 1 and isinstance(sizes[0], (list, tuple, torch.Size)):
        sizes = sizes[0]
    sizes = list(sizes)
    d = split.dim + len(sizes) - x.ndim
    if sizes[d] not in (-1, split.size):
        return _fallback(func, name, args, kwargs)
    sizes[d] = -1
    with suspended():
        out = x.expand(sizes)
    return tag(out, split._replace(dim=d))


def _along(func, name, args, kwargs, default: Optional[int] = 0, pos: int = 1, keep: bool = True):
    """Functions that work along one dimension (``dim``): local when it is not the split
    one (``keep``: the output keeps every dimension)."""
    x, split = _one(args, kwargs)
    dim = args[pos] if len(args) > pos else kwargs.get("dim", default)
    if split is None or dim is None or not isinstance(dim, int) or _dim(dim, x.ndim) == split.dim:
        return _fallback(func, name, args, kwargs)
    if any(split_of(a) is not None and not split_of(a).same(split) for a in args[1:] if isinstance(a, torch.Tensor)):
        return _fallback(func, name, args, kwargs)
    out = func(*args, **kwargs)
    rdim = x.ndim - split.dim  # counted from the right: a dimension gone before it changes nothing
    if not keep and not kwargs.get("keepdim", False) and _dim(dim, x.ndim) > split.dim:
        rdim -= 1
    return _tag_like(out, split, rdim)


def _splits(func, name, args, kwargs):
    """``split``/``chunk``/``tensor_split`` along another dimension than the split one."""
    x, split = _one(args, kwargs)
    dim = args[2] if len(args) > 2 else kwargs.get("dim", 0)
    if _dim(dim, x.ndim) == split.dim:
        return _fallback(func, name, args, kwargs)
    out = func(*args, **kwargs)
    for t in out:
        tag(t, split)
    return out


def _unbind(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    dim = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), x.ndim)
    if dim == split.dim:
        return _fallback(func, name, args, kwargs)
    out = func(*args, **kwargs)
    for t in out:
        tag(t, split._replace(dim=split.dim - (dim < split.dim)))
    return out


def _cat(func, name, args, kwargs):
    tensors = list(args[0] if args else kwargs["tensors"])
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    ref_t = next(t for t in tensors if split_of(t) is not None)
    ref = split_of(ref_t)
    stack = name == "stack"
    if not stack and _dim(dim, ref_t.ndim) == ref.dim:
        return _fallback(func, name, args, kwargs)
    parts = []
    for t in tensors:
        s = split_of(t)
        if s is None:
            if ref.kind == "rows" and t.ndim == ref_t.ndim and t.shape[ref.dim] == ref.size:
                t = local_view(t, ref)
            else:
                return _fallback(func, name, args, kwargs)
        elif not s.same(ref) or s.dim != ref.dim:
            return _fallback(func, name, args, kwargs)
        parts.append(t)
    out = func(parts, dim, **{k: v for k, v in kwargs.items() if k not in ("tensors", "dim")})
    d = ref.dim
    if stack and _dim(dim, ref_t.ndim + 1) <= d:
        d += 1
    return tag(out, ref._replace(dim=d))


def _getitem(func, name, args, kwargs):
    x, index = args[0], args[1]
    split = split_of(x)
    if split is None:  # a whole 1-d table indexed by a split tensor: split as the index
        if isinstance(index, torch.Tensor) and x.ndim == 1 and split_of(index) is not None:
            return tag(func(x, index), split_of(index))
        return _fallback(func, name, args, kwargs)
    items = list(index) if isinstance(index, tuple) else [index]
    if any(isinstance(i, (torch.Tensor, list)) or (i is not None and not isinstance(i, (int, slice))
                                                    and i is not Ellipsis) for i in items):
        return _fallback(func, name, args, kwargs)
    n_dims = sum(1 for i in items if i is not None and i is not Ellipsis)
    if Ellipsis in items:
        e = items.index(Ellipsis)
        items = items[:e] + [slice(None)] * (x.ndim - n_dims) + items[e + 1:]
    items += [slice(None)] * (x.ndim - sum(1 for i in items if i is not None))
    dim = out_dim = 0
    for i in items:
        if i is None:
            out_dim += 1
            continue
        if dim == split.dim:
            whole = isinstance(i, slice) and i.step in (None, 1) and (i.start or 0) in (0, -split.size) \
                and (i.stop is None or i.stop >= split.size)
            if not whole:
                return _fallback(func, name, args, kwargs)
            break
        out_dim += isinstance(i, slice)
        dim += 1
    return tag(func(*args, **kwargs), split._replace(dim=out_dim))


# ----------------------------------------------------------------------------------
# reductions
# ----------------------------------------------------------------------------------
def _reduce(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    if len(args) > 1 and isinstance(args[1], (int, list, tuple)) or "dim" in kwargs:
        dims = args[1] if len(args) > 1 and not isinstance(args[1], torch.dtype) else kwargs.get("dim")
    else:
        dims = None
    dims = list(range(x.ndim)) if dims is None or dims == [] else \
        [_dim(d, x.ndim) for d in (dims if isinstance(dims, (list, tuple)) else [dims])]
    keepdim = args[2] if len(args) > 2 and isinstance(args[2], bool) else kwargs.get("keepdim", False)
    if split.dim not in dims:
        out = func(*args, **kwargs)
        d = split.dim if keepdim else split.dim - sum(d < split.dim for d in dims)
        return tag(out, split._replace(dim=d))
    base = name.strip("_")
    if base in ("mean", "sum", "nansum"):
        dtype = kwargs.get("dtype")
        with suspended():
            part = x.sum(dims, keepdim=keepdim, dtype=dtype)
        total = (C._Sum if split.kind == "rows" else C._SumReplicated).apply(part, split.group)
        if base == "mean":
            shape = _global_shape(x)
            total = total / math.prod(shape[d] for d in dims)
        return total
    if base in ("amax", "amin", "all", "any") and not x.requires_grad:
        with suspended():
            part = func(*args, **kwargs)
        op = dist.ReduceOp.MAX if base in ("amax", "any") else dist.ReduceOp.MIN
        if part.dtype == torch.bool:
            part = part.to(torch.uint8)
            dist.all_reduce(part, op=op, group=split.group)
            return part.bool()
        part = part.clone()
        dist.all_reduce(part, op=op, group=split.group)
        return part
    return _fallback(func, name, args, kwargs)


def _max_min(func, name, args, kwargs):
    """``max``/``min``: over everything (a reduction) or along a dimension."""
    if len(args) > 1 and isinstance(args[1], torch.Tensor) or "other" in kwargs:
        return _pointwise(func, name, args, kwargs)
    if len(args) == 1 and "dim" not in kwargs:
        return _reduce(func, "amax" if name == "max" else "amin", args, kwargs)
    return _along(func, name, args, kwargs, keep=False)


# ----------------------------------------------------------------------------------
# windowed functions along the rows
# ----------------------------------------------------------------------------------
def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _out_rows(size: int, k: int, s: int, p: int, d: int, ceil_mode: bool = False) -> int:
    span = size + 2 * p - d * (k - 1) - 1
    if not ceil_mode:
        return span // s + 1
    out = -(-span // s) + 1
    return out - 1 if (out - 1) * s >= size + p else out


def _slabs(x: torch.Tensor, split: Split, needs, pad_value: float = 0.0) -> List[torch.Tensor]:
    """This rank's row ranges ``needs[rank]`` (global; every rank's needs given: the
    exchange is collective, one call for them all) of ``x``, fetched from their owners
    and each padded with ``pad_value`` where it falls outside the tensor; views of ``x``
    where no rank needs another's rows."""
    clip = [[(max(a, 0), min(b, split.size)) if min(b, split.size) > max(a, 0) else (0, 0) for a, b in n]
            for n in needs]
    me = split.index
    owned = split.all_bounds()
    with suspended():
        if all(o0 <= a and b <= o1 or a == b for n, (o0, o1) in zip(clip, owned) for a, b in n):
            parts = [x.narrow(split.dim, a - owned[me][0] if b > a else 0, b - a) for a, b in clip[me]]
        else:
            rows = C.fetch_rows(x, split.group, split.dim, owned, clip)
            parts = list(rows.split([b - a for a, b in clip[me]], split.dim))
        out = []
        for part, (a, b) in zip(parts, needs[me]):
            top, bottom = max(0, -a), max(0, b - split.size)
            if b > a and (top or bottom):
                keep = max(0, min(b, split.size) - max(a, 0))
                part = F.pad(part.narrow(split.dim, 0, keep), [0, 0] * (x.ndim - 1 - split.dim) +
                             [min(top, b - a), b - a - keep - min(top, b - a)], value=pad_value)
            out.append(part)
    return out


def _slab(x: torch.Tensor, split: Split, needs: Sequence[Tuple[int, int]], pad_value: float = 0.0) -> torch.Tensor:
    """:func:`_slabs` of one range a rank."""
    return _slabs(x, split, [[n] for n in needs], pad_value)[0]


def _window_rows(x: torch.Tensor, split: Split, out_size: int, need_of: Callable[[int, int], Tuple[int, int]],
                 pad_value: float = 0.0):
    """The input rows ``need_of(lo, hi)`` that this rank's output rows ``[lo, hi)`` of
    ``out_size`` need (:func:`_slab`); returns them, their global first row and the
    output's split. Every rank must own at least one output row."""
    out_split = split._replace(size=out_size)
    needs = [need_of(*out_split.bounds(r)) for r in range(split.n)]
    return _slab(x, split, needs, pad_value), needs[split.index][0], out_split


def _rows_ok(split: Optional[Split], out_size: int, dim: int) -> bool:
    return split is not None and split.kind == "rows" and split.dim == dim and out_size >= split.n


def _args(names: Sequence[str], defaults: Dict[str, Any], args, kwargs) -> Dict[str, Any]:
    out = dict(defaults)
    out.update(zip(names, args))
    out.update(kwargs)
    return out


def _conv2d(func, name, args, kwargs):
    a = _args(("input", "weight", "bias", "stride", "padding", "dilation", "groups"),
              {"bias": None, "stride": 1, "padding": 0, "dilation": 1, "groups": 1}, args, kwargs)
    x, w, b = a["input"], a["weight"], a["bias"]
    xs, ws = split_of(x), split_of(w)
    if ws is not None or (xs is not None and xs.kind == "channels"):
        return _conv_channels(func, name, a)
    if split_of(b) is not None or isinstance(a["padding"], str):
        return _fallback(func, name, args, kwargs)
    (sh, sw), (ph, pw), (dh, dw) = _pair(a["stride"]), _pair(a["padding"]), _pair(a["dilation"])
    kh = w.shape[2]
    out_size = _out_rows(xs.size, kh, sh, ph, dh)
    if not _rows_ok(xs, out_size, 2):
        return _fallback(func, name, args, kwargs)
    span = dh * (kh - 1) + 1
    rest = ((sh, sw), (0, pw), (dh, dw), a["groups"])
    out_split = xs._replace(size=out_size)

    def window(lo, hi):  # the input rows of output rows [lo, hi)
        return (lo * sh - ph, (hi - 1) * sh - ph + span) if hi > lo else (0, 0)

    def interior(r):  # the output rows of rank r whose windows lie in its own rows
        (o0, o1), (l0, l1) = out_split.bounds(r), xs.bounds(r)
        lo = min(max(o0, -(-(l0 + ph) // sh)), o1)
        return lo, max(min(o1, (l1 - span + ph) // sh + 1), lo)

    inner = [interior(r) for r in range(xs.n)]
    outs = out_split.all_bounds()
    if any(i1 - i0 < 2 for i0, i1 in inner):  # a block too thin: one slab with its halos
        rows, _, _ = _window_rows(x, xs, out_size, window)
        return tag(func(rows, w, b, *rest), out_split)
    # the interior from this rank's own rows as they lie (no copy of the block); the
    # output rows above and below it from two small slabs, whose halos one exchange
    # brings, stacked on the batch into one conv (zero rows where a rank has no such
    # rows: every rank runs the same calls, so the backward's exchanges pair up)
    top, bottom = _slabs(x, xs, [[window(o0, i0), window(i1, o1)] for (o0, o1), (i0, i1) in zip(outs, inner)])
    (o0, o1), (i0, i1), (l0, _) = out_split.bounds(), inner[xs.index], xs.bounds()
    lo, hi = window(i0, i1)
    n = x.shape[0]
    with suspended():
        rows = max(top.shape[2], bottom.shape[2], span)
        edges = torch.cat([F.pad(t, [0, 0, 0, rows - t.shape[2]]) for t in (top, bottom)], 0)
        edge_out = func(edges, w, b, *rest)
        body = func(x.narrow(2, lo - l0, hi - lo), w, b, *rest)
        out = torch.cat([edge_out[:n, :, : i0 - o0], body, edge_out[n:, :, : o1 - i1]], 2)
    return tag(out, out_split)


def _conv_transpose2d(func, name, args, kwargs):
    a = _args(("input", "weight", "bias", "stride", "padding", "output_padding", "groups", "dilation"),
              {"bias": None, "stride": 1, "padding": 0, "output_padding": 0, "groups": 1, "dilation": 1}, args,
              kwargs)
    x, w, b = a["input"], a["weight"], a["bias"]
    xs = split_of(x)
    (sh, sw), (ph, pw), (oph, opw), (dh, dw) = (_pair(a[k]) for k in ("stride", "padding", "output_padding",
                                                                     "dilation"))
    if xs is None or xs.kind != "rows" or split_of(w) is not None or split_of(b) is not None:
        return _fallback(func, name, args, kwargs)
    kh = w.shape[2]
    out_size = (xs.size - 1) * sh - 2 * ph + dh * (kh - 1) + oph + 1
    if not _rows_ok(xs, out_size, 2):
        return _fallback(func, name, args, kwargs)

    def need(lo, hi):  # output row y takes input rows i with y = i * s - p + j * d
        return -(-(lo + ph - dh * (kh - 1)) // sh), (hi - 1 + ph) // sh + 1

    lo, hi = xs._replace(size=out_size).bounds()
    i0, i1 = need(lo, hi)
    # only rows inside the input contribute: fetch those, not padded ones
    i0c, i1c = max(i0, 0), min(i1, xs.size)
    out_split = xs._replace(size=out_size)
    needs = [(max(p, 0), min(q, xs.size)) for p, q in (need(*out_split.bounds(r)) for r in range(xs.n))]
    needs = [(p, q) if q > p else (0, 0) for p, q in needs]
    rows = C.fetch_rows(x, xs.group, 2, xs.all_bounds(), needs)
    if i1c > i0c:
        y = func(rows, w, None, (sh, sw), (0, pw), (0, opw), a["groups"], (dh, dw))
        made = y.shape[2]  # global rows i0c * s - p ... of the output
        first = i0c * sh - ph
    else:
        y = None
        made, first = 0, lo
    if y is None:
        with suspended():
            y = func(x.narrow(2, 0, 1), w, None, (sh, sw), (0, pw), (0, opw), a["groups"], (dh, dw))
        y = y.new_zeros((y.shape[0], y.shape[1], hi - lo, y.shape[3]))
    else:
        y = F.pad(y, [0, 0, first - lo, (hi - first) - made])
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1).to(y.dtype)
    return tag(y, out_split)


def _max_pool2d(func, name, args, kwargs):
    a = _args(("input", "kernel_size", "stride", "padding", "dilation", "ceil_mode", "return_indices"),
              {"stride": None, "padding": 0, "dilation": 1, "ceil_mode": False, "return_indices": False}, args,
              kwargs)
    x, xs = a["input"], split_of(a["input"])
    (kh, kw) = _pair(a["kernel_size"])
    (sh, sw) = _pair(a["stride"] if a["stride"] not in (None, []) else a["kernel_size"])
    (ph, pw), (dh, dw) = _pair(a["padding"]), _pair(a["dilation"])
    out_size = _out_rows(xs.size, kh, sh, ph, dh, a["ceil_mode"]) if xs.kind == "rows" else 0
    if xs.kind == "channels":
        return _pointwise_window(func, name, args, kwargs)
    if a["return_indices"] or not _rows_ok(xs, out_size, 2):
        return _fallback(func, name, args, kwargs)
    span = dh * (kh - 1) + 1
    low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    rows, _, out_split = _window_rows(x, xs, out_size, lambda lo, hi: (lo * sh - ph, (hi - 1) * sh - ph + span), low)
    return tag(F.max_pool2d(rows, (kh, kw), (sh, sw), (0, pw), (dh, dw), a["ceil_mode"]), out_split)


def _avg_pool2d(func, name, args, kwargs):
    a = _args(("input", "kernel_size", "stride", "padding", "ceil_mode", "count_include_pad", "divisor_override"),
              {"stride": None, "padding": 0, "ceil_mode": False, "count_include_pad": True,
               "divisor_override": None}, args, kwargs)
    x, xs = a["input"], split_of(a["input"])
    if xs.kind == "channels":
        return _pointwise_window(func, name, args, kwargs)
    (kh, kw) = _pair(a["kernel_size"])
    (sh, sw) = _pair(a["stride"] if a["stride"] not in (None, []) else a["kernel_size"])
    (ph, pw) = _pair(a["padding"])
    ceil_mode, include, divisor = a["ceil_mode"], a["count_include_pad"], a["divisor_override"]
    out_size = _out_rows(xs.size, kh, sh, ph, 1, ceil_mode)
    if not _rows_ok(xs, out_size, 2) or (ceil_mode and include and divisor is None):
        return _fallback(func, name, args, kwargs)
    need = lambda lo, hi: (lo * sh - ph, (hi - 1) * sh - ph + kh)  # noqa: E731
    rows, first, out_split = _window_rows(x, xs, out_size, need)
    if include and divisor is None:  # every window k x k, padding counted
        return tag(F.avg_pool2d(rows, (kh, kw), (sh, sw), (0, pw), ceil_mode, True), out_split)
    total = F.avg_pool2d(rows, (kh, kw), (sh, sw), (0, pw), ceil_mode, True, 1)
    if divisor is not None:
        return tag(total / divisor, out_split)
    # count_include_pad=False: divide by the window's elements inside the image
    g = torch.arange(first, first + rows.shape[2], device=x.device)
    valid = ((g >= 0) & (g < xs.size)).to(total.dtype).reshape(1, 1, -1, 1).expand(1, 1, -1, rows.shape[3])
    count = F.avg_pool2d(valid, (kh, kw), (sh, sw), (0, pw), ceil_mode, True, 1)
    return tag(total / count, out_split)


def _pointwise_window(func, name, args, kwargs):
    """A pooling of a channel-split tensor: per channel, local."""
    x, split = _one(args, kwargs)
    return tag(func(*args, **kwargs), split)


def _adaptive_pool(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    size = args[1] if len(args) > 1 else kwargs["output_size"]
    if split.kind == "channels" and split.dim == 1:
        return tag(func(*args, **kwargs), split)
    if name == "adaptive_avg_pool2d" and tuple(_pair(size)) == (1, 1):
        return _reduce(torch.Tensor.mean, "mean", (x, (2, 3), True), {})
    return _fallback(func, name, args, kwargs)


def _interpolate(func, name, args, kwargs):
    a = _args(("input", "size", "scale_factor", "mode", "align_corners", "recompute_scale_factor", "antialias"),
              {"size": None, "scale_factor": None, "mode": "nearest", "align_corners": None,
               "recompute_scale_factor": None, "antialias": False}, args, kwargs)
    x, xs = a["input"], split_of(a["input"])
    mode = a["mode"]
    if xs.kind == "channels" and xs.dim == 1:
        return tag(func(*args, **kwargs), xs)
    if x.ndim != 4 or xs.dim != 2 or a["antialias"] or mode not in ("bilinear", "nearest", "nearest-exact"):
        return _fallback(func, name, args, kwargs)
    size, sf = a["size"], a["scale_factor"]
    sf_pair = None if sf is None else (tuple(sf) if isinstance(sf, (list, tuple)) else (sf, sf))
    if size is not None:
        out_h = _pair(size)[0]
    else:
        out_h = int(math.floor(xs.size * sf_pair[0]))
    if not _rows_ok(xs, out_h, 2):
        return _fallback(func, name, args, kwargs)
    align = bool(a["align_corners"]) if mode == "bilinear" else False
    # torch's source-index scale (area_pixel_compute_scale)
    if align:
        scale = (xs.size - 1) / (out_h - 1) if out_h > 1 else 0.0
    elif sf_pair is not None and not a["recompute_scale_factor"]:
        scale = 1.0 / sf_pair[0]
    else:
        scale = xs.size / out_h
    out_split = xs._replace(size=out_h)
    dev = x.device
    acc = torch.promote_types(x.dtype, torch.float32)  # torch's accumulation type

    def sources(lo, hi):
        y = torch.arange(lo, hi, device=dev, dtype=acc)
        s = torch.tensor(scale, dtype=acc, device=dev)
        if mode == "bilinear":
            src = y * s if align else (s * (y + 0.5) - 0.5).clamp_min(0)
            i0 = src.floor().long().clamp_max(xs.size - 1)
            return i0, (i0 + 1).clamp_max(xs.size - 1), src - i0
        if mode == "nearest":
            return (y * s).floor().long().clamp_max(xs.size - 1), None, None
        return ((y + 0.5) * s).floor().long().clamp_max(xs.size - 1), None, None

    def need(lo, hi):
        i0, i1, _ = sources(lo, hi)
        return int(i0.min()), int((i1 if i1 is not None else i0).max()) + 1

    with suspended():
        needs = [need(*out_split.bounds(r)) for r in range(xs.n)]
        i0, i1, lam = sources(*out_split.bounds())
    rows = C.fetch_rows(x, xs.group, 2, xs.all_bounds(), needs)
    first = needs[xs.index][0]
    lo, hi = out_split.bounds()
    factor = out_h // xs.size
    if not align and out_h == factor * xs.size and scale * factor == 1.0:
        # an integer factor: resizing the fetched rows maps output row t to global row
        # first * factor + t by the same source formula (it commutes with the shift),
        # and each output's neighbour rows lie inside them, so torch's own resize of
        # the rows, cropped, is the whole one's block
        kw = {"mode": mode}
        if mode == "bilinear":
            kw["align_corners"] = a["align_corners"]
        if size is not None:
            kw["size"] = (rows.shape[2] * factor, _pair(size)[1])
        else:
            kw["scale_factor"], kw["recompute_scale_factor"] = sf_pair, a["recompute_scale_factor"]
        y = F.interpolate(rows, **kw)
        return tag(y.narrow(2, lo - first * factor, hi - lo), out_split)
    # any other scale: the width first, as its own resize with the height kept (an
    # identity there), in torch's accumulation type, then the height from the fetched
    # rows
    w_kw = {"mode": mode}
    if mode == "bilinear":
        w_kw["align_corners"] = a["align_corners"]
    if size is not None:
        w_kw["size"] = (rows.shape[2], _pair(size)[1])
    else:
        w_kw["scale_factor"] = (1.0, sf_pair[1])
        w_kw["recompute_scale_factor"] = a["recompute_scale_factor"]
    wide = F.interpolate(rows.to(acc), **w_kw)
    top = wide.index_select(2, i0 - first)
    if lam is not None:
        lam = lam.reshape(1, 1, -1, 1)
        top = top * (1 - lam) + wide.index_select(2, i1 - first) * lam
    return tag(top.to(x.dtype), out_split)


def _pad(func, name, args, kwargs):
    a = _args(("input", "pad", "mode", "value"), {"mode": "constant", "value": None}, args, kwargs)
    x, xs = a["input"], split_of(a["input"])
    pad = list(a["pad"])
    j = x.ndim - 1 - xs.dim  # the pair of the split dimension
    if len(pad) <= 2 * j or (pad[2 * j], pad[2 * j + 1]) == (0, 0):
        return tag(func(*args, **kwargs), xs)
    mode, top, bottom = a["mode"], pad[2 * j], pad[2 * j + 1]
    out_size = xs.size + top + bottom
    if xs.kind != "rows" or out_size < xs.n or mode not in ("constant", "reflect", "replicate") \
            or (mode == "reflect" and max(top, bottom) >= xs.size):
        return _fallback(func, name, args, kwargs)
    pad[2 * j] = pad[2 * j + 1] = 0
    if mode == "constant":
        value = a["value"] or 0.0
        rows, _, out_split = _window_rows(x, xs, out_size, lambda lo, hi: (lo - top, hi - top), value)
        return tag(F.pad(rows, pad, value=value), out_split)

    def source(y: int) -> int:  # the input row an output row copies
        t = y - top
        if mode == "reflect":
            t = abs(t)
            return 2 * (xs.size - 1) - t if t >= xs.size else t
        return min(max(t, 0), xs.size - 1)

    out_split = xs._replace(size=out_size)
    needs = []
    for lo, hi in out_split.all_bounds():
        src = [source(y) for y in range(lo, hi)]
        needs.append((min(src), max(src) + 1))
    rows = _slab(x, xs, needs)
    lo, hi = out_split.bounds()
    index = torch.tensor([source(y) - needs[xs.index][0] for y in range(lo, hi)], device=x.device)
    out = rows.index_select(xs.dim, index)
    return tag(F.pad(out, pad, mode=mode) if any(pad) else out, out_split)


def _int8_quantize(func, name, args, kwargs):
    x, split = _one(args, kwargs)
    if split.dim == x.ndim - 1 or split_of(args[1]) is not None:
        return _fallback(func, name, args, kwargs)
    out = func(*args, **kwargs)
    return tag(out, split)


def _int8_conv(func, name, args, kwargs):
    names = ("x_q", "w_q", "s_x", "w_scale", "bias", "stride", "padding", "dilation", "groups", "out_dtype",
             "w_packed")
    a = _args(names, {}, args, kwargs)
    x, w = a["x_q"], a["w_q"]
    xs, ws = split_of(x), split_of(w)
    if ws is not None:  # column parallel: this rank's output channels from the whole input
        if a["groups"] != 1 or split_of(a["s_x"]) is not None:
            return _fallback(func, name, args, kwargs)
        a["x_q"] = gather(x)
        for k in ("w_q", "w_scale", "bias"):
            if a[k] is not None and split_of(a[k]) is None:
                return _fallback(func, name, args, kwargs)
        out = func(*(a[k] for k in names))
        return tag(out, ws._replace(dim=3))
    if xs.kind != "rows" or xs.dim != 1 or split_of(a["s_x"]) is not None:
        return _fallback(func, name, args, kwargs)
    (sh, sw), (ph, pw), (dh, dw) = _pair(a["stride"]), _pair(a["padding"]), _pair(a["dilation"])
    kh = w.shape[0]
    out_size = _out_rows(xs.size, kh, sh, ph, dh)
    if not _rows_ok(xs, out_size, 1):
        return _fallback(func, name, args, kwargs)
    span = dh * (kh - 1) + 1
    rows, _, out_split = _window_rows(x, xs, out_size, lambda lo, hi: (lo * sh - ph, (hi - 1) * sh - ph + span))
    a.update(x_q=rows.contiguous(), padding=[0, pw], stride=[sh, sw], dilation=[dh, dw])
    return tag(func(*(a[k] for k in names)), out_split)


# ----------------------------------------------------------------------------------
# layers whose parameters are split over the channels (column parallelism)
# ----------------------------------------------------------------------------------
def _parallel_input(x: torch.Tensor, split: Split) -> torch.Tensor:
    """The whole ``x`` as the input of a layer whose weights ``split`` splits: gathered,
    and its gradient summed over the group (each rank's comes through its own outputs)."""
    with suspended():
        return C.to_parallel(gather(x), split.group)


def _conv_channels(func, name, a):
    x, w, b, groups = a["input"], a["weight"], a["bias"], a["groups"]
    ws = split_of(w)
    rest = (a["stride"], a["padding"], a["dilation"])
    if ws is None:  # a replicated conv of a channel-split input: the whole input
        return func(gather(x), w, gather(b) if b is not None else None, *rest, groups)
    if b is not None and split_of(b) is None:
        return func(gather(x), gather(w), b, *rest, groups)
    n = ws.n
    if groups == 1:
        return tag(func(_parallel_input(x, ws), w, b, *rest, 1), ws._replace(dim=1))
    if groups % n == 0:  # whole groups a block: this block's input channels
        xs = split_of(x)
        c_in = w.shape[1] * groups
        if xs is None:
            x = local_view(x, Split(1, c_in, ws.group, "channels"))
        elif not (xs.kind == "channels" and xs.dim == 1 and xs.size == c_in and xs.group is ws.group):
            x = local_view(gather(x), Split(1, c_in, ws.group, "channels"))
        return tag(func(x, w, b, *rest, groups // n), ws._replace(dim=1))
    # a group spans blocks: the whole conv, as GSPMD gathers there
    return func(gather(x), gather(w), gather(b) if b is not None else None, *rest, groups)


def _linear(func, name, args, kwargs):
    a = _args(("input", "weight", "bias"), {"bias": None}, args, kwargs)
    x, w, b = a["input"], a["weight"], a["bias"]
    ws, xs = split_of(w), split_of(x)
    if ws is not None and (b is None or split_of(b) is not None):
        out = func(_parallel_input(x, ws), w, b)
        return tag(out, ws._replace(dim=out.ndim - 1))
    if ws is None and split_of(b) is None and xs is not None and xs.kind == "rows" and xs.dim < x.ndim - 1:
        return tag(func(x, w, b), xs)
    return _fallback(func, name, args, kwargs)


def _batch_norm_over(x, running_mean, running_var, weight, bias, training, momentum, eps, group, flax_var=False):
    """Batch norm whose training statistics are taken over ``group`` (each rank holding
    part of the batch or of the rows): the mean from the summed sums and counts, the
    biased variance from the summed squared deviations, each sum a differentiable
    all-reduce; the running statistics move by ``momentum`` towards the mean and the
    unbiased (``flax_var``: biased) variance. Evaluated on the local blocks."""
    with suspended():
        xf = x.float()
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = C._Sum.apply(torch.cat([xf.sum((0, 2, 3)), count]), group)
        n = sums[-1].detach()
        mean = sums[:-1] / n
        centred = xf - mean.reshape(1, -1, 1, 1)
        var = C._Sum.apply(centred.square().sum((0, 2, 3)), group) / n
        y = centred * torch.rsqrt(var + eps).reshape(1, -1, 1, 1)
        if weight is not None:
            y = y * weight.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)
        if training and running_mean is not None:
            with torch.no_grad():
                unbiased = var if flax_var else var * (n / (n - 1))
                running_mean.lerp_(mean.to(running_mean.dtype), momentum)
                running_var.lerp_(unbiased.to(running_var.dtype), momentum)
        return y.to(x.dtype)


def _batch_norm(func, name, args, kwargs):
    a = _args(("input", "running_mean", "running_var", "weight", "bias", "training", "momentum", "eps"),
              {"running_mean": None, "running_var": None, "weight": None, "bias": None, "training": False,
               "momentum": 0.1, "eps": 1e-5}, args, kwargs)
    x = a["input"]
    params = [a[k] for k in ("running_mean", "running_var", "weight", "bias") if a[k] is not None]
    ps = next((split_of(p) for p in params if split_of(p) is not None), None)
    xs = split_of(x)
    order = ("input", "running_mean", "running_var", "weight", "bias", "training", "momentum", "eps")
    if ps is not None:  # channel-split parameters: this block's channels
        if any(split_of(p) is None for p in params):
            return _fallback(func, name, args, kwargs)
        if xs is None:
            a["input"] = local_view(x, ps._replace(dim=1))
        elif not (xs.same(ps) and xs.dim == 1):
            a["input"] = local_view(gather(x), ps._replace(dim=1))
        return tag(func(*(a[k] for k in order)), ps._replace(dim=1))
    if xs.kind == "channels":
        return _fallback(func, name, args, kwargs)
    if xs.dim == 1:
        return _fallback(func, name, args, kwargs)
    if not a["training"]:
        return tag(func(*(a[k] for k in order)), xs)
    y = _batch_norm_over(x, a["running_mean"], a["running_var"], a["weight"], a["bias"], True, a["momentum"],
                         a["eps"], xs.group)
    return tag(y, xs)


def _layer_norm(func, name, args, kwargs):
    a = _args(("input", "normalized_shape", "weight", "bias", "eps"), {"weight": None, "bias": None, "eps": 1e-5},
              args, kwargs)
    x, xs = a["input"], split_of(a["input"])
    k = len(a["normalized_shape"])
    if xs is None or xs.dim >= x.ndim - k or split_of(a["weight"]) is not None or split_of(a["bias"]) is not None:
        return _fallback(func, name, args, kwargs)
    return tag(func(*args, **kwargs), xs)


def _softmax(func, name, args, kwargs):
    return _along(func, name, args, kwargs, default=None)


def _foreach(func, name, args, kwargs):
    """``torch._foreach_*``: elementwise over lists, so on the blocks, each output split
    as its input; a norm is a reduction and takes the fallback."""
    if "norm" in name:
        return _fallback(func, name, args, kwargs)
    out = func(*args, **kwargs)
    if isinstance(out, (list, tuple)):
        for t, ref in zip(out, args[0]):
            if isinstance(t, torch.Tensor) and split_of(ref) is not None and t.shape == ref.shape:
                tag(t, split_of(ref))
    return out


_RULES: Dict[str, Callable] = {
    "shape.__get__": _shape_get, "size": _size, "numel": _numel, "__len__": _len,
    "grad.__get__": _same_split_get, "data.__get__": _same_split_get,
    "permute": _permute, "transpose": _transpose, "swapaxes": _transpose, "swapdims": _transpose,
    "movedim": _movedim, "moveaxis": _movedim, "unsqueeze": _unsqueeze, "squeeze": _squeeze,
    "reshape": _reshape, "view": _reshape, "reshape_as": _reshape_as, "view_as": _reshape_as,
    "flatten": _flatten, "expand": _expand,
    "split": _splits, "chunk": _splits, "tensor_split": _splits, "split_with_sizes": _splits, "unbind": _unbind,
    "cat": _cat, "concat": _cat, "concatenate": _cat, "stack": _cat,
    "__getitem__": _getitem,
    "mean": _reduce, "sum": _reduce, "nansum": _reduce, "amax": _reduce, "amin": _reduce, "all": _reduce,
    "any": _reduce, "max": _max_min, "min": _max_min,
    "argmax": lambda f, n, a, k: _along(f, n, a, k, default=None, keep=False),
    "argmin": lambda f, n, a, k: _along(f, n, a, k, default=None, keep=False),
    "softmax": _softmax, "log_softmax": _softmax, "cumsum": _softmax,
    "gather": _along, "take_along_dim": lambda f, n, a, k: _along(f, n, a, k, pos=2),
    "index_select": _along, "topk": lambda f, n, a, k: _along(f, n, a, k, pos=2, default=-1),
    "sort": lambda f, n, a, k: _along(f, n, a, k, default=-1),
    "conv2d": _conv2d, "conv_transpose2d": _conv_transpose2d, "max_pool2d": _max_pool2d,
    "avg_pool2d": _avg_pool2d, "adaptive_avg_pool2d": _adaptive_pool, "adaptive_max_pool2d": _adaptive_pool,
    "interpolate": _interpolate, "pad": _pad, "linear": _linear, "batch_norm": _batch_norm,
    "layer_norm": _layer_norm, "int8_quantize": _int8_quantize, "int8_conv": _int8_conv,
}
for _n in ("dim", "ndimension", "ndim.__get__", "dtype.__get__", "device.__get__", "is_cuda.__get__",
           "requires_grad.__get__", "grad_fn.__get__", "is_leaf.__get__", "layout.__get__", "stride",
           "is_contiguous", "data_ptr", "element_size", "is_floating_point", "is_complex", "storage_offset",
           "get_device", "__format__", "__repr__", "grad.__set__", "data.__set__", "requires_grad.__set__",
           "untyped_storage", "_is_view", "is_pinned", "itemsize.__get__", "is_sparse.__get__",
           "is_quantized.__get__", "is_meta.__get__", "names.__get__", "_version.__get__", "output_nr.__get__",
           "__hash__", "new_zeros", "new_ones", "new_empty", "new_full", "new_tensor"):
    _RULES[_n] = _passthrough


def tree_gather(out):
    """``out`` (a tensor or a structure of them) with every split tensor gathered."""
    return tree_map(lambda t: gather(t) if split_of(t) is not None else t, out)
