"""Sharded batch inference across processes: the port of ``holocron_tpu/parallel/inference.py``.

The batch splits over the mesh's ``data`` axis and the logits come back whole on every
process. ``head_tensor_parallel`` also splits the classifier head's output over the
``model`` axis; ``tensor_parallel`` splits the whole backbone there (column
parallelism, one rule for every model): every tensor whose per-output-channel
dimension is wide enough (:func:`tensor_parallel_specs`) is held as this process's
block, and the forward runs under :class:`~holocron_tpu_torch.parallel.sharded.SplitMode`,
where each layer whose weights are split computes its block of the output channels,
per-channel work (batch norm, activations, depthwise or grouped convs whose groups fall
whole in a block, pooling) stays on the blocks, and a consumer that needs every input
channel (a dense conv, the head, a layer norm over the channels, a join with a
replicated operand, a grouped conv whose groups span blocks) gathers them first. An
int8 :class:`~holocron_tpu_torch.quant.QuantizedModel` splits its int8 kernels and
per-channel scales by the same rule; each process runs its layer's route (the ``wgmma``
conv, or the pointwise GEMM at a 1x1 stride-1 conv) on its block of the output
channels, with weights packed once a block.
"""

import copy
from typing import Callable, Dict, Mapping, Optional, Union

import torch
from torch import distributed as dist
from torch import nn

from .mesh import Sharding, create_mesh
from .sharded import STATE, Split, SplitMode, bounds, split_of, tag, tree_gather

__all__ = ["shard_inference", "tensor_parallel_specs"]


def _non_persistent(module: nn.Module) -> set:
    return {f"{name}.{b}" if name else b for name, m in module.named_modules()
            for b in getattr(m, "_non_persistent_buffers_set", ())}


def output_channel_dims(module_or_state: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Optional[int]]:
    """Each tensor's per-output-channel dimension, by name (the ``state_dict``'s
    tensors): 0 for torch's layouts (OIHW kernels, ``Linear`` ``(out, in)``, norm
    vectors, per-channel scales), 1 for a transposed conv's ``(in, out, kh, kw)``, 3
    for an int8 kernel's HWIO ``kernel_q``; None for a scalar. A ``state_dict`` alone
    does not say which kernels are transposed: pass the module for those."""
    if isinstance(module_or_state, nn.Module):
        from ..quant import QuantizedConv2d

        skip = _non_persistent(module_or_state)
        dims = {}
        for mname, m in module_or_state.named_modules():
            for tname, t in [*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)]:
                name = f"{mname}.{tname}" if mname else tname
                if name in skip or t is None:
                    continue
                d: Optional[int] = 0
                if isinstance(m, nn.ConvTranspose2d) and tname == "weight":
                    d = 1
                elif isinstance(m, QuantizedConv2d) and tname == "kernel_q":
                    d = 3
                dims[name] = d if t.ndim > d else None
        return dims
    return {name: (3 if name.endswith("kernel_q") else 0) if t.ndim >= 1 else None
            for name, t in module_or_state.items()}


def tensor_parallel_specs(module_or_state, mesh, axis: str = "model", min_channels: int = 64) -> Dict[str, Sharding]:
    """Channel sharding of a model's tensors, by name (``inference.py:31-53``): a tensor
    whose per-output-channel dimension (:func:`output_channel_dims`; the trailing one
    of the JAX package's layouts) is at least ``min_channels`` wide and divisible by
    the axis' size is split there over ``axis``; everything else replicates.

    Returns ``{name: Sharding}`` over the model's ``state_dict`` tensors (parameters,
    batch norm statistics, int8 kernels and scales), ``Shard(dim)`` on ``axis``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    n = mesh.size(names.index(axis))
    state = module_or_state.state_dict() if isinstance(module_or_state, nn.Module) else module_or_state
    specs = {}
    for name, d in output_channel_dims(module_or_state).items():
        t = state[name]
        split = d is not None and t.shape[d] >= min_channels and t.shape[d] % n == 0
        specs[name] = Sharding(mesh, tuple(Shard(d) if split and a == axis else Replicate() for a in names))
    return specs


def _split_dim(sharding: Sharding, axis: str) -> Optional[int]:
    from torch.distributed.tensor import Shard

    p = sharding.placements[sharding.mesh.mesh_dim_names.index(axis)]
    return p.dim if isinstance(p, Shard) else None


@torch.no_grad()
def shard_module(model: nn.Module, specs: Mapping[str, Sharding], axis: str = "model") -> nn.Module:
    """Replaces, in place, each tensor that ``specs`` split over ``axis`` by this
    process's block of it (a copy), tagged with its :class:`~holocron_tpu_torch.parallel.
    sharded.Split`; an int8 conv's packed and folded kernels are remade once from its
    block. Move the model before, not after: a move remakes those from the block
    untagged."""
    from ..quant import QuantizedConv2d

    modules = dict(model.named_modules())
    touched = set()
    for name, sharding in specs.items():
        d = _split_dim(sharding, axis)
        if d is None:
            continue
        mname, _, tname = name.rpartition(".")
        m = modules[mname]
        t = getattr(m, tname)
        group = sharding.mesh.get_group(axis)
        split = Split(d, t.shape[d], group, "channels")
        lo, hi = split.bounds()
        block = t.detach().narrow(d, lo, hi - lo).clone()
        if isinstance(t, nn.Parameter):
            block = nn.Parameter(block, requires_grad=t.requires_grad)
            setattr(m, tname, block)
        else:
            m._buffers[tname] = block
        tag(block, split)
        block.__dict__[STATE] = True
        touched.add(mname)
    for mname in touched:
        m = modules[mname]
        if isinstance(m, QuantizedConv2d) and split_of(m.kernel_q) is not None:
            m.kernel_packed = m._packed()  # packed once, from the block
            m._fold()
            if m.kernel_s2d_q is not None:
                tag(m.kernel_s2d_q, split_of(m.kernel_q)).__dict__[STATE] = True
    return model


def _model_device(model: nn.Module) -> torch.device:
    t = next(iter([*model.parameters(), *model.buffers()]), None)
    return t.device if t is not None else torch.device("cpu")


def _data_block(x: torch.Tensor, mesh, batch_axis: Optional[str]):
    """This process's rows of the batch over ``batch_axis`` (all of them without one),
    and the row counts of every block."""
    if batch_axis is None or batch_axis not in mesh.mesh_dim_names:
        return x, None
    group = mesh.get_group(batch_axis)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    lo, hi = bounds(x.shape[0], n, i)
    return x[lo:hi], (group, [bounds(x.shape[0], n, r)[1] - bounds(x.shape[0], n, r)[0] for r in range(n)])


def _gather_batch(y, blocks):
    """The whole batch from every block over the batch axis (a gather with no gradient)."""
    if blocks is None:
        return y
    from torch.utils._pytree import tree_map

    from .collectives import _gather_uneven

    group, sizes = blocks
    return tree_map(lambda t: _gather_uneven(t, group, 0, sizes) if isinstance(t, torch.Tensor) else t, y)


def shard_inference(
    model: nn.Module,
    mesh=None,
    head_tensor_parallel: bool = False,
    tensor_parallel: bool = False,
    min_channels: int = 64,
) -> Callable:
    """Returns ``x -> logits`` running the model data-parallel over the mesh's processes
    (``inference.py:56-139``).

    Args:
        model: a model in eval form (reparametrize or quantize first as desired; a
            :class:`~holocron_tpu_torch.quant.QuantizedModel` works too), on this
            process's device. It is copied: the caller's model stays whole.
        mesh: defaults to a one-axis ``("data",)`` mesh over every process
        head_tensor_parallel: also split the head's ``Linear`` (a module under a
            ``head``) by its outputs over the mesh's ``model`` axis
        tensor_parallel: split the whole model over the ``model`` axis
            (:func:`tensor_parallel_specs`, the module docstring); with a ``("data",
            "model")`` mesh, DP x TP
        min_channels: the narrowest per-channel dimension split under ``tensor_parallel``

    The callable takes the whole batch on every process (a tensor or an array), runs
    this process's rows of it over the ``data`` axis and returns the whole logits on
    every process: a collective, which every process calls in lockstep.
    """
    if mesh is None:
        mesh = create_mesh(axes=("data",))
    names = mesh.mesh_dim_names
    if (tensor_parallel or head_tensor_parallel) and "model" not in names:
        raise ValueError("tensor_parallel requires a mesh with a 'model' axis")
    model = copy.deepcopy(model).eval()
    if tensor_parallel:
        shard_module(model, tensor_parallel_specs(model, mesh, min_channels=min_channels))
    elif head_tensor_parallel:
        from torch.distributed.tensor import Replicate, Shard

        specs = {}
        for mname, m in model.named_modules():
            if isinstance(m, nn.Linear) and "head" in mname.split("."):
                for tname in ("weight", "bias"):
                    if getattr(m, tname) is not None:
                        specs[f"{mname}.{tname}"] = Sharding(
                            mesh, tuple(Shard(0) if a == "model" else Replicate() for a in names))
        shard_module(model, specs)
    device = _model_device(model)

    @torch.no_grad()
    def run(x):
        x = torch.as_tensor(x).to(device)
        x, blocks = _data_block(x, mesh, "data")
        with SplitMode():
            y = tree_gather(model(x))
        return _gather_batch(y, blocks)

    run.model = model
    return run
