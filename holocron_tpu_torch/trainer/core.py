"""The training engine, one device a process: the port of ``holocron_tpu/trainer/core.py``.

The JAX trainer compiles one step (forward, loss, gradients, clip, accumulation,
update, BN statistics) and wraps its optimizer in optax transforms. The port runs the
same step eagerly and applies the same update chain by hand, from the inside out:

1. clip the trainable gradients by their global norm (``optax.clip_by_global_norm``:
   ``g * max_norm / norm`` when ``norm >= max_norm``, no epsilon);
2. the optimizer, over the trainable parameters (param groups carry the
   ``norm_weight_decay``);
3. frozen parameters get no update;
4. accumulation over ``gradient_acc`` batches (``optax.MultiSteps``): a running mean
   ``acc + (g - acc) / (n + 1)``, the parameters move and the optimizer's count
   advances only on the last batch of each group;
5. skipping non-finite gradients (``optax.apply_if_finite``): such a step changes
   no parameter and no optimizer or accumulator state, unless it is more than
   ``nan_tolerance`` in a row, when the update is applied as it is.

BN running statistics come from every forward, a skipped step's too (``core.py:496-503``),
except those of fully frozen BN layers. ``amp`` is the JAX package's bf16 compute, not
``torch.autocast``: every parameter and the input are cast to bfloat16 for the forward
(the batch norms' parameters to bfloat16 values kept in float32, the dtype in which
batch norm takes them; a LayerNorm's to bfloat16, as the JAX package casts every
parameter), the logits are cast to float32 before the loss, and the
gradients land on the float32 parameters.

``remat`` recomputes the forward in the backward (``core.py:474-484``) with
``torch.utils.checkpoint`` (non-reentrant) over the step's loss: ``True`` / ``"full"``
keeps nothing of the forward, ``"dots"`` keeps the outputs of convolutions and matrix
products alone (``jax.checkpoint_policies.dots_saveable``, through
``create_selective_checkpoint_contexts``). The recomputation updates no batch norm's
running statistics (they move once a step, as without ``remat``) and draws the same
random masks: checkpointing restores the global generators, and the explicit
``generator`` of a module (ConvNeXt's stochastic depth) is replayed too.

Data parallelism across processes (the JAX trainer's mesh over hosts): with a process
group joined (:func:`~holocron_tpu_torch.parallel.initialize`), each process trains on
its own shard of every batch (``EpochDataLoader(num_shards="auto")``). The parameters
and buffers start from rank 0's; the gradients are averaged over the processes right
after the backward, in buckets of all-reduces (``_all_reduce_grads``), before
accumulation, clipping and the non-finite check, so every process takes the same
update and the same skip decision; with more than one process each batch norm takes its
statistics over the global batch (:class:`~holocron_tpu_torch.parallel.CrossProcessBatchNorm2d`),
as the JAX step does. DDP's reducer is not used: its hooks fire through the wrapper's
``forward`` and ``loss.backward()``, which the step (``functional_call`` under amp,
``checkpoint`` under remat, ``torch.autograd.grad``) does not go through.
``shard_opt_state`` (ZeRO-1): each process keeps the optimizer state of its partition
of the parameters only, steps it, and broadcasts the updated parameters.

``model_parallel`` and ``spatial_parallel`` (``core.py:144-175``, mutually exclusive)
lay the processes on a ``("data", "model")`` or ``("data", "spatial")`` mesh; the
batch splits over ``data`` (the trainer shards its loaders' ``num_shards="auto"``
samplers over that axis), and the step's
forward and loss, and under tensor parallelism its update, run under
:class:`~holocron_tpu_torch.parallel.sharded.SplitMode`:

- tensor parallelism: every parameter, batch norm statistic and optimizer moment whose
  output channels are ``tp_min_channels`` or wider and divide the axis is held as this
  process's block (:func:`~holocron_tpu_torch.parallel.tensor_parallel_specs`), the
  layers column-parallel; the loss is the whole one on every process of a model group,
  each gradient its block's whole one, so the gradients are averaged over the data
  group only; clipping's and LAMB's norms are summed over the blocks; ZeRO-1 is a no-op.
- spatial parallelism: each batch's rows (and a dense target's, split with the image;
  other targets whole) split over the spatial axis, H divisible by it; every
  reduction over the rows is summed over the group, so the loss is the global one on
  every process, and its gradient each process's share times the group's size:
  averaged over every process, as under data parallelism, they are the one-process
  gradients. Batch norm takes its statistics over the data and spatial processes.

The reported loss is the global one (averaged over the data group); ``save`` writes
whole tensors to a file, or each process its own blocks to a directory, and either
restores into any layout's trainer.
"""

import contextlib
import math
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call
from torch import profiler
from torch.profiler import record_function
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from torch import distributed as dist

from ..optim.schedules import constant_schedule, cosine_decay_schedule, cosine_onecycle_schedule
from ..parallel import sharded
from ..parallel.batchnorm import convert_batchnorm
from ..utils.data.loader import ShardSampler, prefetch
from ._progress import ProgressBar
from .utils import freeze_bn, freeze_model, split_normalization_params

__all__ = ["Trainer"]

REMAT_MODES = (False, True, "full", "dots")
BUCKET_BYTES = 25 * 2**20  # the gradients all-reduced in one call (DDP's default bucket)
# the ops whose outputs "dots" keeps: what dots_saveable keeps (dot_general and
# conv_general_dilated), as they reach the dispatcher below autograd
DOTS_SAVEABLE = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                 torch.ops.aten.bmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in DOTS_SAVEABLE else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


@contextlib.contextmanager
def _running_stats_kept(model: nn.Module):
    """The batch norms' running statistics and counters as they were before the block:
    the recomputation runs the same train-mode forward, saving the same tensors for the
    backward, and its second update is undone."""
    stats = [b for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
             for b in (m.running_mean, m.running_var, m.num_batches_tracked) if b is not None]
    saved = [b.clone() for b in stats]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(stats, saved):
                b.copy_(v)


class _GeneratorReplay:
    """The explicit generators of a model's modules (a ``generator`` attribute), set
    back for the recomputation to the states they had when the forward began, and left
    after it where the forward left them."""

    def __init__(self, model: nn.Module) -> None:
        self.generators = list({id(g): g for m in model.modules()
                                if isinstance(g := getattr(m, "generator", None), torch.Generator)}.values())
        self.start: List[torch.Tensor] = []

    @contextlib.contextmanager
    def forward(self):
        self.start = [g.get_state() for g in self.generators]
        yield

    @contextlib.contextmanager
    def recompute(self):
        after = [g.get_state() for g in self.generators]
        for g, state in zip(self.generators, self.start):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(self.generators, after):
                g.set_state(state)


class Trainer:
    """Baseline trainer (``core.py:38-139``), one device a process.

    Args:
        model: the model to train; it is moved to ``device``
        train_loader: iterable of ``(x, target)`` NCHW batches (torch tensors)
        val_loader: validation iterable
        criterion: ``(logits, target) -> scalar loss``
        optimizer: a factory ``(param_groups, lr) -> torch.optim.Optimizer`` whose ``lr``
            may be a schedule ``count -> value``, as the port's optimizers take (e.g.
            ``functools.partial(LAMB, weight_decay=5e-5)``)
        device: where the model and the step run: the card unless the caller asks for
            the CPU
        output_file: checkpoint destination
        amp: bf16 compute (see the module docstring)
        skip_nan_loss: skip updates on non-finite gradients
        nan_tolerance: consecutive non-finite steps skipped before one is applied
        gradient_acc: batches accumulated into each update
        gradient_clip: global-norm gradient clip value
        on_epoch_end: callback fed each epoch's eval metrics
        input_norm: ``(mean, std)``; uint8 batches are normalized on the device inside
            the step, ``(x / 255 - mean) / std`` per channel; float batches pass as they are
        remat: ``False``, ``True`` / ``"full"`` or ``"dots"`` (see the module docstring)
        model_parallel: the ``model`` axis' size: tensor parallelism above 1 (see the
            module docstring)
        tp_min_channels: the narrowest per-channel dimension split under
            ``model_parallel``
        spatial_parallel: the ``spatial`` axis' size: spatial partitioning above 1
        shard_opt_state: ZeRO-1 across the processes (see the module docstring); a
            no-op under ``model_parallel``
    """

    def __init__(
        self,
        model: nn.Module,
        train_loader: Optional[Iterable] = None,
        val_loader: Optional[Iterable] = None,
        criterion: Optional[Callable] = None,
        optimizer: Optional[Callable] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        output_file: str = "./checkpoint.pt",
        amp: bool = False,
        skip_nan_loss: bool = False,
        nan_tolerance: int = 5,
        gradient_acc: int = 1,
        gradient_clip: Optional[float] = None,
        on_epoch_end: Optional[Callable[[Dict[str, float]], Any]] = None,
        input_norm: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
        remat: Union[bool, str] = False,
        model_parallel: int = 1,
        tp_min_channels: int = 64,
        spatial_parallel: int = 1,
        shard_opt_state: bool = False,
    ) -> None:
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be False, True/'full', or 'dots', got {remat!r}")
        self.remat = remat
        self.distributed = dist.is_available() and dist.is_initialized()
        self.world_size = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.device = torch.device(device)
        self.model_parallel, self.tp_min_channels, self.spatial_parallel = model_parallel, tp_min_channels, \
            spatial_parallel
        self._set_mesh()
        self.shard_opt_state = shard_opt_state and model_parallel == 1
        self.model = model.to(self.device)
        if self.world_size > 1:
            # batch norm over the processes that hold the same channels: the data group
            # under tensor parallelism, every process otherwise
            convert_batchnorm(self.model, self._data_group if model_parallel > 1 else None)
            with torch.no_grad():  # every process starts from rank 0's weights, as DDP does
                for t in [*self.model.parameters(), *self.model.buffers()]:
                    dist.broadcast(t, 0)
        if model_parallel > 1:
            from ..parallel.inference import shard_module, tensor_parallel_specs

            shard_module(self.model, tensor_parallel_specs(self.model, self.mesh, min_channels=tp_min_channels))
        self.train_loader = train_loader
        self.val_loader = val_loader
        if self.mesh is not None:  # the processes of a model or spatial group read the same rows
            for loader in (train_loader, val_loader):
                sampler = getattr(loader, "sampler", None)
                if isinstance(sampler, ShardSampler) and sampler.auto:
                    sampler.shard_over(self._data_group)
        self.criterion = criterion
        self.optimizer = optimizer
        self.amp = amp
        self.skip_nan_loss = skip_nan_loss
        self.nan_tolerance = nan_tolerance
        self.gradient_acc = gradient_acc
        self.grad_clip = gradient_clip
        self.on_epoch_end = on_epoch_end
        self.output_file = output_file
        self.input_norm = None
        if input_norm is not None:
            mean, std = (torch.tensor(v, dtype=torch.float32, device=self.device).reshape(1, -1, 1, 1)
                         for v in input_norm)
            self.input_norm = (mean, std)

        self.step = 0
        self.start_epoch = 0
        self.epoch = 0
        self.min_loss = math.inf
        self.skipped_steps = 0  # updates rejected for non-finite gradients
        self.lr_recorder: List[float] = []
        self.loss_recorder: List[float] = []

        self._opt: Optional[torch.optim.Optimizer] = None
        self._trainable: Dict[str, bool] = {}
        self._frozen_bn: List[nn.Module] = []
        # a group of their own under norm_weight_decay
        self._norm_names = set(split_normalization_params(self.model)[0])
        # amp casts these to bf16 values kept in float32, the dtype in which batch norm
        # takes them (a LayerNorm takes its parameters in the input's dtype: bf16)
        self._f32_norm_names = self._norm_names - {
            f"{name}.{p}" if name else p for name, m in self.model.named_modules() if isinstance(m, nn.LayerNorm)
            for p, _ in m.named_parameters(recurse=False)}
        self._acc: List[torch.Tensor] = []
        self._mini_step = 0
        self._notfinite = 0
        self._owned: List[List[torch.Tensor]] = []  # ZeRO-1: the trainable parameters each rank steps

    # ------------------------------------------------------------------
    # processes (``core.py:144-283``)
    # ------------------------------------------------------------------
    def _set_mesh(self) -> None:
        """The mesh of ``model_parallel`` / ``spatial_parallel`` (``core.py:144-175``) and
        the groups the step reduces over: ``_data_group`` (the processes that hold
        different rows of the batch) and ``_grad_group`` (those whose gradients are
        averaged: the data group under tensor parallelism, every process otherwise)."""
        mp, sp = self.model_parallel, self.spatial_parallel
        if mp > 1 and sp > 1:
            raise ValueError("model_parallel and spatial_parallel cannot be combined — pick one "
                             "(data parallelism composes with either over the leading axis)")
        self.mesh = None
        self._data_group = self._grad_group = dist.group.WORLD if self.distributed else None
        self._spatial_group = None
        if mp == 1 and sp == 1:
            self._data_size = self.world_size
            return
        if self.world_size % max(mp, sp) != 0:
            raise ValueError(f"{self.world_size} devices cannot host a "
                             f"{'model' if mp > 1 else 'spatial'}-parallel factor of {max(mp, sp)}")
        from ..parallel.mesh import create_mesh

        axes = ("data", "model") if mp > 1 else ("data", "spatial")
        self.mesh = create_mesh(axes, max(mp, sp), device_type=self.device.type)
        self._data_group = self.mesh.get_group("data")
        self._data_size = dist.get_world_size(self._data_group)
        if mp > 1:
            self._grad_group = self._data_group
        else:
            self._spatial_group = self.mesh.get_group("spatial")

    def _split_mode(self):
        """The split-tensor mode under tensor or spatial parallelism, else nothing."""
        return sharded.SplitMode() if self.mesh is not None else contextlib.nullcontext()

    def _split_batch(self, x, target):
        """Spatial parallelism (``core.py:222-240``): this process's rows of the batch on
        the device, and of a dense target (``(N, H, W, ...)`` with the image's H and W),
        split with the image; other targets whole. H must divide the axis."""
        if self._spatial_group is None:
            return x, target
        n = dist.get_world_size(self._spatial_group)
        x = x.to(self.device, non_blocking=True)
        h, w = int(x.shape[2]), int(x.shape[3])
        if h % n != 0:
            raise ValueError(f"spatial_parallel={n} needs the image height to divide; got H={h}")

        def split_target(t):
            if isinstance(t, torch.Tensor) and t.ndim >= 3 and tuple(t.shape[1:3]) == (h, w):
                return sharded.split_rows(t.to(self.device, non_blocking=True), 1, self._spatial_group)
            if isinstance(t, dict):
                return {k: split_target(v) for k, v in t.items()}
            return t

        return sharded.split_rows(x, 2, self._spatial_group), split_target(target)

    def _host_batch(self, arr: torch.Tensor, bs: int) -> torch.Tensor:
        """The real rows of every process's eval batch, in rank order, on the device
        (``core.py:250-271``): ``arr[:bs]`` with one process, else an all-gather over
        the data group of each rank's first ``bs`` rows (their counts gathered first),
        so that every process computes the same metrics over the whole validation view.
        A collective: every process calls it in lockstep."""
        arr = arr[:bs]
        if self._data_size == 1:
            return arr
        group = self._data_group
        arr = arr.to(self.device).contiguous()
        sizes = [torch.zeros(1, dtype=torch.int64, device=self.device) for _ in range(self._data_size)]
        dist.all_gather(sizes, torch.tensor([arr.shape[0]], dtype=torch.int64, device=self.device), group=group)
        sizes = [int(n) for n in torch.cat(sizes).tolist()]
        padded = arr.new_zeros((max(sizes), *arr.shape[1:]))
        padded[: arr.shape[0]] = arr
        parts = [torch.empty_like(padded) for _ in sizes]
        dist.all_gather(parts, padded, group=group)
        return torch.cat([p[:n] for p, n in zip(parts, sizes)])

    def _all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Averages ``grads`` over ``_grad_group`` in place (the data group under tensor
        parallelism, every process otherwise; see the module docstring): the gradients
        flattened into buckets of up to :data:`BUCKET_BYTES` a dtype, one all-reduce
        (sum) a bucket, divided by the group's size. With one process the result is the
        input, bit for bit."""
        group = self._grad_group
        size = dist.get_world_size(group) if group is not None else 1
        if size == 1:
            return
        buckets: Dict[torch.dtype, List[List[torch.Tensor]]] = {}
        for g in grads:
            runs = buckets.setdefault(g.dtype, [[]])
            if runs[-1] and sum(t.numel() for t in runs[-1]) * g.element_size() + g.nbytes > BUCKET_BYTES:
                runs.append([])
            runs[-1].append(g)
        for runs in buckets.values():
            for bucket in runs:
                flat = torch.cat([g.reshape(-1) for g in bucket])
                dist.all_reduce(flat, group=group)
                flat.div_(size)
                for g, piece in zip(bucket, flat.split([g.numel() for g in bucket])):
                    g.copy_(piece.view(g.shape))

    def _partition(self, params: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        """ZeRO-1's partition of ``params`` over the ranks: largest first, each to the
        rank holding the fewest elements so far (the same on every process)."""
        owned: List[List[torch.Tensor]] = [[] for _ in range(self.world_size)]
        load = [0] * self.world_size
        for p in sorted(params, key=lambda p: -p.numel()):
            r = load.index(min(load))
            owned[r].append(p)
            load[r] += p.numel()
        return owned

    def _broadcast_owned(self) -> None:
        """ZeRO-1: each rank's updated parameters sent to the others, one broadcast a
        rank (the parameters flattened)."""
        for src, params in enumerate(self._owned):
            if not params:
                continue
            if src == self.rank:
                flat = torch.cat([p.detach().reshape(-1) for p in params])
            else:
                flat = params[0].new_empty(sum(p.numel() for p in params))
            dist.broadcast(flat, src)
            if src != self.rank:
                for p, piece in zip(params, flat.split([p.numel() for p in params])):
                    p.data.copy_(piece.view(p.shape))

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _named_splits(self) -> Dict[str, sharded.Split]:
        """The tensors of the model's ``state_dict`` held as blocks, by name."""
        return {n: sharded.split_of(t) for n, t in [*self.model.named_parameters(), *self.model.named_buffers()]
                if sharded.split_of(t) is not None}

    def save(self, output_file: str) -> None:
        """Saves ``{epoch, step, min_loss, model}`` (the model's ``state_dict``)
        (``core.py:277-310``). It holds the model, not the optimizer state, as in the JAX
        package. Across processes every process calls it in lockstep.

        A path with a suffix is one ``torch.save`` file, written by rank 0; tensors held
        as blocks (tensor parallelism) are gathered whole first. A path with no suffix
        is a ``torch.distributed.checkpoint`` directory (the JAX package's orbax path):
        each process writes only its own blocks, at their global offsets, so a model too
        large to gather still saves. Either restores into any layout."""
        path = Path(output_file)
        meta = {"epoch": self.epoch, "step": self.step, "min_loss": self.min_loss}
        if not path.suffix:  # torch.distributed.checkpoint takes a second to import
            from ._sharded_checkpoint import save_directory

            save_directory(path, meta, self.model.state_dict(), self._named_splits())
            return
        state = self.model.state_dict()
        splits = self._named_splits()
        if splits:
            with torch.no_grad():
                whole = {n: dict([*self.model.named_parameters(), *self.model.named_buffers()])[n] for n in splits}
                state = {k: sharded.gather(whole[k]).detach() if k in splits else v for k, v in state.items()}
        if self.rank == 0:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({**meta, "model": state}, path)
        if self.distributed:
            dist.barrier()

    def load(self, state: Union[str, Path, Dict[str, Any]]) -> None:
        """Resumes from a state saved by :meth:`save`, or its file or directory
        (``core.py:312-327``); under tensor parallelism each tensor held as blocks takes
        its block (from a directory, each process reads only its block). A directory is
        read by every process in lockstep."""
        if isinstance(state, (str, Path)) and Path(state).is_dir():
            from ._sharded_checkpoint import load_directory

            state = load_directory(Path(state), self.model.state_dict(), self._named_splits())
        else:
            if isinstance(state, (str, Path)):
                state = torch.load(state, map_location=self.device, weights_only=True)
            model_state = dict(state["model"])
            for name, split in self._named_splits().items():
                lo, hi = split.bounds()
                model_state[name] = model_state[name].narrow(split.dim, lo, hi - lo)
            state = {**state, "model": model_state}
        self.start_epoch = int(state["epoch"])
        self.epoch = self.start_epoch
        self.step = int(state["step"])
        self.min_loss = float(state["min_loss"])
        self.model.load_state_dict(state["model"])

    # ------------------------------------------------------------------
    # optimizer / schedule setup
    # ------------------------------------------------------------------
    @staticmethod
    def _make_schedule(lr: float, total_steps: int, sched_type: str, **kwargs: Any):
        if sched_type == "onecycle":
            return cosine_onecycle_schedule(total_steps, lr, **kwargs)
        if sched_type == "cosine":
            return cosine_decay_schedule(lr, total_steps, **kwargs)
        if sched_type == "constant":
            return constant_schedule(lr)
        raise ValueError(f"The following scheduler type is not supported: {sched_type}")

    def _reset_opt(
        self,
        lr_or_schedule,
        norm_weight_decay: Optional[float] = None,
        freeze_until: Optional[str] = None,
    ) -> None:
        """Builds the optimizer over the trainable parameters and resets the
        accumulation and non-finite state (``core.py:348-429``)."""
        if self.optimizer is None:
            raise ValueError("optimizer must be a factory (param_groups, lr) -> torch.optim.Optimizer")
        self._trainable = freeze_model(self.model, freeze_until)
        if not any(self._trainable.values()):
            raise AssertionError("All parameters are frozen")
        self._frozen_bn = freeze_bn(self.model, self._trainable) if freeze_until is not None else []
        trainable = [(n, p) for n, p in self.model.named_parameters() if self._trainable[n]]
        if norm_weight_decay is None:
            groups = [{"params": [p for _, p in trainable]}]
        else:
            # the norm group's decay replaces the optimizer's own (core.py:376-397)
            groups = [
                {"params": [p for n, p in trainable if n not in self._norm_names]},
                {"params": [p for n, p in trainable if n in self._norm_names], "weight_decay": norm_weight_decay},
            ]
            groups = [g for g in groups if g["params"]]
        self._owned = []
        if self.shard_opt_state and self.world_size > 1:
            self._owned = self._partition([p for g in groups for p in g["params"]])
            mine = {id(p) for p in self._owned[self.rank]}
            groups = [g for g in ({**g, "params": [p for p in g["params"] if id(p) in mine]} for g in groups)
                      if g["params"]]
        self._opt = self.optimizer(groups, lr=lr_or_schedule) if groups else None
        self._acc = [sharded.tag(torch.zeros_like(p), sharded.split_of(p)) for p in self.model.parameters()] \
            if self.gradient_acc > 1 else []
        self._mini_step = 0
        self._notfinite = 0

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        """The batch on the device, a uint8 one normalized by ``input_norm``."""
        x = x.to(self.device, non_blocking=True)
        if self.input_norm is not None and x.dtype == torch.uint8:
            mean, std = self.input_norm
            x = (x.float() / 255.0 - mean) / std
        return x

    def _input_prep(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 batches normalized on the device, then the amp cast (``core.py:431-446``)."""
        x = self._normalize(x)
        return x.to(torch.bfloat16) if self.amp else x

    def _call_model(self, *args: Any) -> Any:
        """The model on prepared arguments, with bf16 parameters under amp."""
        if not self.amp:
            return self.model(*args)
        params = {
            # batch norm takes its affine parameters in float32: bf16 values, f32 dtype
            name: p.to(torch.bfloat16).float() if name in self._f32_norm_names else p.to(torch.bfloat16)
            for name, p in self.model.named_parameters()
        }
        return functional_call(self.model, params, args)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The model on a prepared input, with bf16 parameters under amp, logits in
        float32."""
        return self._call_model(x).float()

    def _loss(self, x: torch.Tensor, target) -> torch.Tensor:
        """The step's loss on a batch: ``criterion(logits, target)``, the part of the
        step that differs by task (``core.py:448-461``)."""
        target = target.to(self.device, non_blocking=True) if isinstance(target, torch.Tensor) else target
        return self.criterion(self._forward(self._input_prep(x)), target)

    def _remat_contexts(self):
        """``checkpoint``'s ``context_fn`` under ``remat``: the forward's and the
        recomputation's contexts."""
        generators = _GeneratorReplay(self.model)
        forward, recompute = [generators.forward()], [generators.recompute(), _running_stats_kept(self.model),
                                                      self._split_mode()]
        if self.remat == "dots":
            keep, redo = create_selective_checkpoint_contexts(_dots_saveable)
            forward.append(keep)
            recompute.append(redo)
        return _entered(*forward), _entered(*recompute)

    def _step_loss(self, x: torch.Tensor, target) -> torch.Tensor:
        """:meth:`_loss`, recomputed in the backward under ``remat``."""
        if not self.remat:
            return self._loss(x, target)
        return checkpoint(self._loss, x, target, use_reentrant=False, context_fn=self._remat_contexts)

    def _run_step_async(self, x: torch.Tensor, target) -> torch.Tensor:
        """One train step; returns the loss on the device, without reading it back."""
        self.model.train()
        frozen_stats = [(m.running_mean.clone(), m.running_var.clone()) for m in self._frozen_bn]
        x, target = self._split_batch(x, target)
        with record_function("train_step.forward"), self._split_mode():
            loss = self._step_loss(x, target)
        names, params = zip(*self.model.named_parameters())
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for m, (mean, var) in zip(self._frozen_bn, frozen_stats):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
            grads = [sharded.tag(torch.zeros_like(p) if g is None else g, sharded.split_of(p))
                     for p, g in zip(params, grads)]
            if self.world_size > 1:
                with record_function("train_step.all_reduce"):
                    self._all_reduce_grads(grads)
            with record_function("train_step.update"), \
                    (self._split_mode() if self.model_parallel > 1 else contextlib.nullcontext()):
                self._apply_update(names, params, grads)
            loss = loss.detach()
            if self._data_size > 1:  # the global loss: the mean over the data group
                loss = loss.clone()
                dist.all_reduce(loss, group=self._data_group)
                loss.div_(self._data_size)
        return loss

    @torch.no_grad()
    def _apply_update(self, names: Sequence[str], params: Sequence[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """apply_if_finite(MultiSteps(frozen-masked(clip -> optimizer)))."""
        if self.skip_nan_loss:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self._notfinite = 0 if finite else self._notfinite + 1
            if not finite and self._notfinite <= self.nan_tolerance:
                self.skipped_steps += 1
                return
        if self.gradient_acc > 1:
            n = self._mini_step
            for acc, g in zip(self._acc, grads):
                acc.copy_(acc + (g - acc) / (n + 1))
            self._mini_step = (n + 1) % self.gradient_acc
            if n != self.gradient_acc - 1:
                return
            grads = [acc.clone() for acc in self._acc]
            for acc in self._acc:
                acc.zero_()
        live = [(p, g) for name, p, g in zip(names, params, grads) if self._trainable[name]]
        if self.grad_clip is not None:
            norm = torch.sqrt(sum(torch.sum(torch.square(g)) for _, g in live))
            keep = norm < self.grad_clip
            live = [(p, torch.where(keep, g, g / norm * self.grad_clip)) for p, g in live]
        for p, g in live:
            p.grad = g
        if self._opt is not None:
            self._opt.step()
        for p in params:
            p.grad = None
        if self._owned:
            self._broadcast_owned()

    def _run_step(self, x, target) -> float:
        return float(self._run_step_async(x, target))

    def _place(self, batch: Tuple[Any, Any]) -> Tuple[Any, Any]:
        """A batch on the device: each CPU tensor of it (the input, a target tensor or a
        padded target's tensors) pinned and copied with ``non_blocking``, so that the
        copy overlaps the device's work; other targets (lists of dicts) as they are."""

        def place(t):
            if isinstance(t, dict):
                return {k: place(v) for k, v in t.items()}
            if not isinstance(t, torch.Tensor) or t.device == self.device:
                return t
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        x, target = batch
        return place(x), place(target)

    # ------------------------------------------------------------------
    # training loops
    # ------------------------------------------------------------------
    def _fit_epoch(self) -> None:
        """One pass over the training set (``core.py:526-574``). The loss is read back
        four steps late, so that the host keeps queueing work while the device runs; the
        non-finite tolerance check fires as late."""
        nan_cnt = 0
        readback_lag = 4

        def check(batch_loss: float) -> int:
            if self.skip_nan_loss and not math.isfinite(batch_loss):
                if nan_cnt + 1 > self.nan_tolerance:
                    raise ValueError(f"loss value has been NaN or inf for more than {self.nan_tolerance} steps.")
                return nan_cnt + 1
            return 0

        pbar = ProgressBar(
            total=len(self.train_loader) if hasattr(self.train_loader, "__len__") else None,
            desc=f"epoch {self.epoch + 1}",
        )
        pending: deque = deque()
        # placed two batches ahead (``core.py:555-559``): their copies to the device run
        # while it computes the current step
        for x, target in prefetch(self.train_loader, self._place, size=2):
            pending.append(self._run_step_async(x, target))
            batch_loss = None
            if len(pending) > readback_lag:
                batch_loss = float(pending.popleft())
                nan_cnt = check(batch_loss)
            pbar.update(1, loss=batch_loss)
            self.step += 1
        while pending:
            batch_loss = float(pending.popleft())
            nan_cnt = check(batch_loss)
            pbar.loss = batch_loss
        pbar.close()
        self.epoch += 1

    def evaluate(self) -> Dict[str, float]:
        raise NotImplementedError

    @staticmethod
    def _eval_metrics_str(eval_metrics) -> str:
        raise NotImplementedError

    def fit_n_epochs(
        self,
        num_epochs: int,
        lr: float,
        freeze_until: Optional[str] = None,
        sched_type: str = "onecycle",
        norm_weight_decay: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        """Trains for ``num_epochs`` (``core.py:583-610``): freeze, reset the optimizer
        and the schedule, then per epoch train, evaluate, save the best state on
        ``val_loss`` and call ``on_epoch_end``."""
        steps_per_epoch = len(self.train_loader) if hasattr(self.train_loader, "__len__") else 1
        schedule = self._make_schedule(lr, num_epochs * steps_per_epoch, sched_type, **kwargs)
        self._reset_opt(schedule, norm_weight_decay, freeze_until)
        for _ in range(num_epochs):
            self._fit_epoch()
            eval_metrics = self.evaluate()
            print(f"Epoch {self.epoch}/{self.start_epoch + num_epochs} - {self._eval_metrics_str(eval_metrics)}")  # noqa: T201
            if eval_metrics["val_loss"] < self.min_loss:
                print(  # noqa: T201
                    f"Validation loss decreased {self.min_loss:.4} --> {eval_metrics['val_loss']:.4}: saving state..."
                )
                self.min_loss = eval_metrics["val_loss"]
                self.save(self.output_file)
            if self.on_epoch_end is not None:
                self.on_epoch_end(eval_metrics)

    def find_lr(
        self,
        freeze_until: Optional[str] = None,
        start_lr: float = 1e-7,
        end_lr: float = 1,
        norm_weight_decay: Optional[float] = None,
        num_it: int = 100,
    ) -> None:
        """The exponential learning-rate sweep (``core.py:612-642``): step ``k`` trains
        at ``start_lr * gamma ** k`` (the optimizer's 0-based count), ``gamma`` taking
        ``num_it`` steps from ``start_lr`` to ``end_lr``; stops at the first non-finite
        loss (raises if it is the first). Leaves ``lr_recorder`` and ``loss_recorder``,
        of equal length."""
        if hasattr(self.train_loader, "__len__") and num_it > len(self.train_loader):
            raise ValueError("the value of `num_it` needs to be lower than the number of available batches")
        gamma = (end_lr / start_lr) ** (1 / (num_it - 1))
        self._reset_opt(lambda count: start_lr * gamma**count, norm_weight_decay, freeze_until)
        self.lr_recorder = [start_lr * gamma**idx for idx in range(num_it)]
        self.loss_recorder: List[float] = []
        for batch_idx, (x, target) in enumerate(self.train_loader):
            batch_loss = self._run_step(x, target)
            if math.isnan(batch_loss) or math.isinf(batch_loss):
                if batch_idx == 0:
                    raise ValueError("loss value is NaN or inf.")
                break
            self.loss_recorder.append(batch_loss)
            if batch_idx + 1 == num_it:
                break
        self.lr_recorder = self.lr_recorder[: len(self.loss_recorder)]

    def plot_recorder(self, beta: float = 0.95, **kwargs: Any) -> None:
        """Plots the learning-rate finder's curve (``core.py:644-668``): the losses
        smoothed by an exponential average with bias correction, the first tenth (at
        most 10) and the last twentieth (at most 5) left out, against the learning rate
        on a log scale. ``kwargs`` go to ``plt.show``."""
        if len(self.lr_recorder) != len(self.loss_recorder) or len(self.lr_recorder) == 0:
            raise AssertionError("Please run the `lr_find` method first")
        import matplotlib.pyplot as plt
        import numpy as np

        smoothed_losses = []
        avg_loss = 0.0
        for idx, loss in enumerate(self.loss_recorder):
            avg_loss = beta * avg_loss + (1 - beta) * loss
            smoothed_losses.append(avg_loss / (1 - beta ** (idx + 1)))
        data_slice = slice(
            min(len(self.loss_recorder) // 10, 10),
            -min(len(self.loss_recorder) // 20, 5) if len(self.loss_recorder) >= 20 else len(self.loss_recorder),
        )
        vals = np.array(smoothed_losses[data_slice])
        min_idx = vals.argmin()
        max_val = vals[: min_idx + 1].max()
        delta = max_val - vals[min_idx]
        plt.plot(self.lr_recorder[data_slice], smoothed_losses[data_slice])
        plt.xscale("log")
        plt.xlabel("Learning Rate")
        plt.ylabel("Training loss")
        plt.ylim(vals[min_idx] - 0.1 * delta, max_val + 0.2 * delta)
        plt.grid(True, linestyle="--", axis="x")
        plt.show(**kwargs)

    def check_setup(
        self,
        freeze_until: Optional[str] = None,
        lr: float = 3e-4,
        norm_weight_decay: Optional[float] = None,
        num_it: int = 100,
    ) -> List[float]:
        """Overfits one batch (``core.py:670-688``); returns the losses."""
        x, target = next(iter(self.train_loader))
        self._reset_opt(lr, norm_weight_decay, freeze_until)
        losses = []
        for _ in range(num_it):
            batch_loss = self._run_step(x, target)
            if math.isnan(batch_loss) or math.isinf(batch_loss):
                raise ValueError("loss value is NaN or inf.")
            losses.append(batch_loss)
        return losses

    def profile(self, num_steps: int = 5, lr: float = 1e-3) -> profiler.profile:
        """Profiles ``num_steps`` train steps on the first batch with ``torch.profiler``
        (``core.py:690-702``), after one step outside the trace. Each step's forward,
        backward and update are ranges of their own (``train_step.*``). Returns the
        profiler: ``key_averages()`` gives host and device time by range, op and kernel.
        The steps train the model, with the current optimizer (a constant ``lr`` if
        there is none yet)."""
        x, target = next(iter(self.train_loader))
        if self._opt is None:
            self._reset_opt(lr)
        self._run_step(x, target)
        activities = [profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(profiler.ProfilerActivity.CUDA)
        with profiler.profile(activities=activities) as prof:
            for _ in range(num_steps):
                self._run_step_async(x, target)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return prof

    @torch.no_grad()
    def _eval_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode logits in float32, amp as in training (``core.py:705-730``). Under
        tensor parallelism they are gathered whole; under spatial parallelism a dense
        output is this process's rows of it (tagged), other outputs whole."""
        self.model.eval()
        x, _ = self._split_batch(x, None)
        with self._split_mode():
            out = self._forward(self._input_prep(x))
            if self.model_parallel > 1:
                out = sharded.tree_gather(out)
        return out
