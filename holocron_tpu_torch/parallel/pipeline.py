"""Pipeline parallelism (GPipe) over a stack of identical blocks: the port of
``holocron_tpu/parallel/pipeline.py``.

A run of ``S`` shape-preserving blocks (darknet53's eight 512-channel residual blocks, a
transformer's layers) is split into ``n`` contiguous groups, one a process along a
``pipe`` mesh axis, and ``M`` microbatches stream through the groups, the activations
hopping from process to process (:func:`~holocron_tpu_torch.parallel.collectives.ppermute`).
The schedule is the JAX package's, tick for tick: ``M + n - 1`` ticks, a bubble
fraction of ``(n - 1) / (M + n - 1)``, and two conveyor belts, rings of ``M`` microbatch
slots of which each process holds ``M / n``, shifted one slot towards process 0 each
tick. Stage 0 reads microbatch ``t`` at its input belt's head on tick ``t``; the other
stages read the activation that hopped in from the previous one; stage ``n - 1`` drops
each finished microbatch on its output belt's tail, where it rides the remaining ticks
to its final slot (a warm-up bubble on the belt is overwritten on the very tick its slot
comes round, so nothing is masked). A process holds ``2·B/n`` of belts and one
circulating microbatch ``B/M``, not the batch.

Where the JAX package runs one SPMD program (a ``lax.scan`` of ticks in a
``shard_map``), each process here runs its own stage and its ticks are launched from
the host, one process a device. A belt is a Python list of microbatch slots: a shift
drops the head and appends the slot that came in, so nothing is written in place and a
slot's memory is freed when it leaves. Gradients flow through the schedule by an
explicit backward, the same schedule run in reverse (each belt shifted the other way,
each hop sent back, every tick on every process, so the point-to-point messages pair up
in the same order everywhere; autograd alone would skip the hops whose result a process
drops and leave its neighbour waiting), each stage's blocks recomputed from the
microbatch inputs it kept (GPipe's rematerialization).
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import collectives as C
from .mesh import create_mesh

__all__ = ["pipeline_blocks", "pipeline_module", "stack_stage_variables", "stage_variables"]


class _Schedule:
    """One process's stage of the GPipe schedule: its ``per`` blocks (``local``, the
    leaves of its slice of the stacked parameters) and the ticks."""

    def __init__(self, block_fn: Callable, spec, per: int, n: int, idx: int, m: int, axis: str, mesh) -> None:
        self.block_fn, self.spec, self.per = block_fn, spec, per
        self.n, self.idx, self.m, self.axis, self.mesh = n, idx, m, axis, mesh
        # one slot towards process 0 (belt shift) / one stage onwards (activation hop)
        self.left = [(i, (i - 1) % n) for i in range(n)]
        self.right = [(i, (i + 1) % n) for i in range(n)]

    def _send(self, x: torch.Tensor, pairs) -> torch.Tensor:
        return C.ppermute(x, pairs, self.axis, self.mesh)

    def _real(self, t: int) -> bool:
        """Whether this stage works on a real microbatch at tick ``t`` (else its output
        never reaches the output belt)."""
        return self.idx <= t < self.idx + self.m

    def run(self, local: Sequence[torch.Tensor], box: List[torch.Tensor]) -> torch.Tensor:
        """This stage's blocks applied to the one tensor in ``box``, taken out of it so
        that it is freed once the first block has read it (unless the caller keeps it)."""
        h = box.pop()
        for i in range(self.per):
            h = self.block_fn(tree_unflatten([t[i] for t in local], self.spec), h)
        return h

    def forward(self, mbs: torch.Tensor, local, inputs: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The ``M + n - 1`` ticks over this process's belt shard ``mbs`` (``M/n``
        microbatches); returns its output belt shard, stacked. ``inputs`` collects the
        stage's input at each tick of a real microbatch, for the backward."""
        belt = list(mbs.unbind(0))
        out_belt = [torch.zeros_like(belt[0])] * len(belt)
        state = out_belt[0]
        for t in range(self.m + self.n - 1):
            # while the blocks run, this process holds its two belt shards and the one
            # microbatch in flight (past stage 0, the hop is freed as it is read)
            box, state = [belt[0] if self.idx == 0 else state], None
            if inputs is not None and self._real(t):
                inputs.append(box[0].detach())
            out = self.run(local, box)
            belt = belt[1:] + [self._send(belt[0], self.left)]
            out_belt = out_belt[1:] + [self._send(out_belt[0], self.left)]
            if self.idx == self.n - 1:
                out_belt[-1] = out
            state, out = self._send(out, self.right), None
        del belt, state  # freed before the stack, so the peak stays at two belt shards
        return torch.stack(out_belt)

    def backward(self, g: torch.Tensor, local, inputs: List[torch.Tensor], needs: Sequence[bool]):
        """The ticks in reverse: the cotangent of each output slot rides the output belt
        back to stage ``n - 1``, each stage's input cotangent hops back a stage, and
        stage 0 puts its own on the input belt, which carries it back to its microbatch's
        slot. Returns the cotangent of ``mbs`` and of each leaf of ``local`` (None where
        ``needs`` is False)."""
        g_out_belt = list(g.unbind(0))
        zero = torch.zeros_like(g_out_belt[0])
        g_belt = [zero] * len(g_out_belt)
        g_state = zero
        params = [t.detach().requires_grad_(need) for t, need in zip(local, needs)]
        diff = [i for i, need in enumerate(needs) if need]
        grads: List[Optional[torch.Tensor]] = [None] * len(local)
        for t in reversed(range(self.m + self.n - 1)):
            g_out = zero
            if self.idx == self.n - 1:
                g_out, g_out_belt[-1] = g_out_belt[-1], zero
            g_out_belt = [self._send(g_out_belt[-1], self.right)] + g_out_belt[:-1]
            g_belt = [self._send(g_belt[-1], self.right)] + g_belt[:-1]
            g_out = g_out + self._send(g_state, self.left)
            g_inp = zero
            if self._real(t):
                with torch.enable_grad():
                    inp = inputs[t - self.idx].detach().requires_grad_()
                    got = torch.autograd.grad(self.run(params, [inp]), [inp, *(params[i] for i in diff)], g_out)
                g_inp = got[0]
                for i, gi in zip(diff, got[1:]):
                    grads[i] = gi if grads[i] is None else grads[i] + gi
            if self.idx == 0:
                g_belt[0] = g_belt[0] + g_inp
                g_state = zero
            else:
                g_state = g_inp
        return torch.stack(g_belt), grads


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, mbs: torch.Tensor, *local: torch.Tensor) -> torch.Tensor:
        ctx.sched, ctx.inputs = sched, []
        ctx.save_for_backward(*local)
        return sched.forward(mbs, local, ctx.inputs)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g_mbs, grads = ctx.sched.backward(g.contiguous(), ctx.saved_tensors, ctx.inputs, ctx.needs_input_grad[2:])
        ctx.inputs = None
        return (None, g_mbs, *grads)


def pipeline_blocks(
    block_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    mesh=None,
    axis: str = "pipe",
    num_microbatches: Optional[int] = None,
    gather_output: bool = False,
) -> torch.Tensor:
    """Applies ``S`` stacked blocks in sequence, pipelined over the processes of
    ``axis`` (``pipeline.py:54-158``), one stage a process.

    Args:
        block_fn: ``(params_i, x) -> y`` for ONE block, ``y.shape == x.shape`` (the
            GPipe buffer contract); ``params_i`` has ``stacked_params``' structure
        stacked_params: a dict (a pytree) of tensors with a leading dimension ``S``,
            the same on every process; ``S`` must divide by the axis' size, each
            process running its ``S/n`` consecutive blocks
        x: the whole batch ``(B, ...)``, the same on every process; split into
            ``num_microbatches`` equal microbatches along dim 0 (``B`` must divide),
            of which each process keeps its own ``M/n`` on its input belt
        mesh: defaults to a one-axis ``(axis,)`` mesh over every process
        axis: the mesh axis the stages are laid out along
        num_microbatches: defaults to the stage count; a multiple of it (the belts
            spread the microbatches evenly over the processes)
        gather_output: return the whole batch on every process (its gradient is
            each process's own rows of it); by default each process returns its own
            ``M/n`` microbatches, rows ``[p·B/n, (p+1)·B/n)`` of the result

    Numerically the fold of ``block_fn`` over the ``S`` blocks on one device (tested).
    Gradients flow to ``stacked_params`` (each process's blocks) and ``x`` (each
    process's rows), as the gradient of the sum of every process's loss. A collective:
    every process of the axis calls it in lockstep, and the backward too.
    """
    if mesh is None:
        mesh = create_mesh(axes=(axis,))
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no '{axis}' axis (axes: {mesh.mesh_dim_names})")
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    leaves, spec = tree_flatten(stacked_params)
    s = leaves[0].shape[0]
    if s % n != 0:
        raise ValueError(f"{s} blocks cannot split into {n} pipeline stages")
    m = num_microbatches if num_microbatches is not None else n
    if m % n != 0:
        raise ValueError(f"{m} microbatches cannot spread over {n} belt shards")
    if x.shape[0] % m != 0:
        raise ValueError(f"batch {x.shape[0]} does not divide into {m} microbatches")
    idx = C.axis_index(axis, mesh)
    per, k = s // n, m // n
    local = [leaf[idx * per:(idx + 1) * per] for leaf in leaves]
    mbs = x.reshape(m, x.shape[0] // m, *x.shape[1:])[idx * k:(idx + 1) * k]
    sched = _Schedule(block_fn, spec, per, n, idx, m, axis, mesh)
    if torch.is_grad_enabled() and (mbs.requires_grad or any(t.requires_grad for t in local)):
        y = _GPipe.apply(sched, mbs, *local)
    else:
        y = sched.forward(mbs, local)
    y = y.reshape(k * mbs.shape[1], *x.shape[1:])
    if gather_output:
        y = C.gather_replicated(y, mesh.get_group(axis), 0)
    return y


def _stage_blocks(module: nn.Module, path: str) -> List[Tuple[str, nn.Module]]:
    """The longest run of consecutive children of one class under the submodule at the
    dotted ``path`` (``""``: ``module`` itself), as ``(name, block)``."""
    try:
        parent = module.get_submodule(path)
    except AttributeError as err:
        raise ValueError(f"no submodule {path!r} in the model") from err
    runs: List[List[Tuple[str, nn.Module]]] = []
    for name, child in parent.named_children():
        if runs and type(child) is type(runs[-1][0][1]):
            runs[-1].append((name, child))
        else:
            runs.append([(name, child)])
    longest = max((len(r) for r in runs), default=0)
    if longest < 2:
        raise ValueError(f"{path!r} holds no run of two or more blocks of one class — nothing to pipeline")
    best = [r for r in runs if len(r) == longest]
    if len(best) > 1:
        raise ValueError(f"{path!r} is ambiguous — runs of {longest} blocks start at "
                         f"{[r[0][0] for r in best]}")
    return best[0]


def stack_stage_variables(module: nn.Module, path: str) -> dict:
    """The ``state_dict`` of a run of sibling blocks, stacked (``pipeline.py:161-219``).

    ``path`` is the dotted name of the parent module (darknet53's 512-channel stage:
    ``"features.layers.3"``, whose children ``3`` to ``10`` are its eight
    :class:`~holocron_tpu_torch.models.classification.darknetv3.ResBlock`); the stage
    is the longest run of consecutive children of one class there, every block's
    ``state_dict`` matching the first one's names, shapes and dtypes. Returns
    ``{name in a block: tensor with a leading S}``, parameters and buffers (batch norm
    statistics) alike: the ``stacked_variables`` of :func:`pipeline_module`. Raises
    ``ValueError`` for a path that names no module, a run of one block and blocks that
    do not match.
    """
    blocks = _stage_blocks(module, path)
    states = [(name, b.state_dict()) for name, b in blocks]
    first_name, first = states[0]
    for name, sd in states[1:]:
        if sd.keys() != first.keys() or any(sd[k].shape != v.shape or sd[k].dtype != v.dtype for k, v in first.items()):
            raise ValueError(f"block {path}.{name} does not match {path}.{first_name}'s structure")
    return {k: torch.stack([sd[k] for _, sd in states]) for k in first}


def stage_variables(model: nn.Module, path: str) -> dict:
    """The stacked variables of ``model``'s stage at ``path``: the counterpart of
    ``Model.stage_variables`` (``holocron_tpu/models/core.py:159-169``), the model hook
    for pipeline parallelism (darknet53: ``stage_variables(model,
    "features.layers.3")``). Raises ``RuntimeError`` when the model holds no weights."""
    params = list(model.parameters())
    if not params or any(p.is_meta for p in params):
        raise RuntimeError("the model holds no weights")
    return stack_stage_variables(model, path)


def pipeline_module(
    block: nn.Module,
    stacked_variables,
    x: torch.Tensor,
    mesh=None,
    axis: str = "pipe",
    num_microbatches: Optional[int] = None,
    gather_output: bool = False,
) -> torch.Tensor:
    """GPipe over a stack of one block's variables (``pipeline.py:222-254``), from
    :func:`stack_stage_variables` or :func:`stage_variables`.

    ``block`` is a module matching ONE block of the stack (``ResBlock(512, 256)`` for
    darknet53's stage 3), applied with each block's variables through
    ``torch.func.functional_call`` in eval form: each call puts it in eval mode and then
    back in the mode it was in, and batch norm reads the stacked running statistics
    (GPipe's microbatches cannot give whole-batch statistics). Gradients with respect to
    the stacked variables flow through the schedule (tested).

    Example, darknet53's 512-channel stage over the processes::

        stacked = stage_variables(model, "features.layers.3")
        y = pipeline_module(ResBlock(512, 256).to(device), stacked, stage_in,
                            mesh=create_mesh(axes=("pipe",)), num_microbatches=8)
    """

    def block_fn(vars_i, h):
        training = block.training
        block.eval()
        try:
            return functional_call(block, vars_i, (h,))
        finally:
            block.train(training)

    return pipeline_blocks(block_fn, dict(stacked_variables), x, mesh, axis, num_microbatches, gather_output)
