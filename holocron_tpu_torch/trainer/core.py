"""The training engine on one device: the port of ``holocron_tpu/trainer/core.py``.

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

from ..optim.schedules import constant_schedule, cosine_decay_schedule, cosine_onecycle_schedule
from ..utils.data.loader import prefetch
from ._progress import ProgressBar
from .utils import freeze_bn, freeze_model, split_normalization_params

__all__ = ["Trainer"]

REMAT_MODES = (False, True, "full", "dots")
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
    """Baseline trainer (``core.py:38-139``), on one device.

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
    ) -> None:
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be False, True/'full', or 'dots', got {remat!r}")
        self.remat = remat
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.train_loader = train_loader
        self.val_loader = val_loader
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

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def save(self, output_file: str) -> None:
        """Saves ``{epoch, step, min_loss, model}`` (the model's ``state_dict``) with
        ``torch.save`` (``core.py:277-310``)."""
        path = Path(output_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        state = {"epoch": self.epoch, "step": self.step, "min_loss": self.min_loss, "model": self.model.state_dict()}
        torch.save(state, path)

    def load(self, state: Union[str, Path, Dict[str, Any]]) -> None:
        """Resumes from a state saved by :meth:`save` or its path (``core.py:312-327``)."""
        if isinstance(state, (str, Path)):
            state = torch.load(state, map_location=self.device, weights_only=True)
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
        self._opt = self.optimizer(groups, lr=lr_or_schedule)
        self._acc = [torch.zeros_like(p) for p in self.model.parameters()] if self.gradient_acc > 1 else []
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
        forward, recompute = [generators.forward()], [generators.recompute(), _running_stats_kept(self.model)]
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
        with record_function("train_step.forward"):
            loss = self._step_loss(x, target)
        names, params = zip(*self.model.named_parameters())
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad(), record_function("train_step.update"):
            for m, (mean, var) in zip(self._frozen_bn, frozen_stats):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            self._apply_update(names, params, grads)
        return loss.detach()

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
        self._opt.step()
        for p in params:
            p.grad = None

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
        """Eval-mode logits in float32, amp as in training (``core.py:705-730``)."""
        self.model.eval()
        return self._forward(self._input_prep(x))
