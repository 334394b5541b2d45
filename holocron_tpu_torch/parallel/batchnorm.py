"""Batch norm over the global batch of a data-parallel job.

The JAX package's jitted step normalizes each batch norm over the whole (sharded)
batch. The port's processes hold one shard each, so across processes a batch norm in
training sums its per-channel moments over the group: the port's own, since
``torch.nn.SyncBatchNorm`` takes CUDA tensors only and the CPU tests run on gloo.
"""

from typing import Optional

import torch
from torch import distributed as dist
from torch import nn

from ..nn.modules._norm import FlaxBatchNorm2d
from .collectives import _Sum

__all__ = ["CrossProcessBatchNorm2d", "CrossProcessFlaxBatchNorm2d", "convert_batchnorm"]


class CrossProcessBatchNorm2d(nn.BatchNorm2d):
    """A batch norm whose training forward takes its statistics over every process's
    batch: the mean from the summed per-channel sums and counts, then the biased
    variance from the summed squared deviations (two passes, as torch's), each sum a
    differentiable all-reduce (its backward sums the gradients over the processes), in
    float32; the output in the input's dtype. The running statistics move as those of
    ``nn.BatchNorm2d``'s (:class:`CrossProcessFlaxBatchNorm2d`: towards the biased
    variance, as :class:`~holocron_tpu_torch.nn.modules._norm.FlaxBatchNorm2d`'s).

    Outside training, or with one process, it is the module it replaces, bit for bit.
    """

    flax_running_var: bool = False
    group: Optional[object] = None

    def _world(self) -> int:
        return dist.get_world_size(self.group) if dist.is_available() and dist.is_initialized() else 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self._world() == 1:
            return super().forward(x)
        group = self.group if self.group is not None else dist.group.WORLD
        xf = x.float()
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = _Sum.apply(torch.cat([xf.sum((0, 2, 3)), count]), group)
        n = sums[-1].detach()
        mean = sums[:-1] / n
        centred = xf - mean.reshape(1, -1, 1, 1)
        var = _Sum.apply(centred.square().sum((0, 2, 3)), group) / n
        y = centred * torch.rsqrt(var + self.eps).reshape(1, -1, 1, 1)
        if self.affine:
            y = y * self.weight.reshape(1, -1, 1, 1) + self.bias.reshape(1, -1, 1, 1)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                factor = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
                running_var = var if self.flax_running_var else var * (n / (n - 1))
                self.running_mean.lerp_(mean, factor)
                self.running_var.lerp_(running_var, factor)
        return y.to(x.dtype)


class CrossProcessFlaxBatchNorm2d(CrossProcessBatchNorm2d, FlaxBatchNorm2d):
    """:class:`CrossProcessBatchNorm2d` in place of a ``FlaxBatchNorm2d``."""

    flax_running_var = True


def convert_batchnorm(model: nn.Module, group=None) -> nn.Module:
    """``model`` with each ``nn.BatchNorm2d`` and ``FlaxBatchNorm2d`` replaced in place by
    its cross-process form holding the same parameters and buffers (the same tensors,
    under the same names); other norms stay. Returns ``model``."""
    forms = {nn.BatchNorm2d: CrossProcessBatchNorm2d, FlaxBatchNorm2d: CrossProcessFlaxBatchNorm2d}
    for name, child in list(model.named_children()):
        if type(child) in forms:
            bn = forms[type(child)](child.num_features, child.eps, child.momentum, child.affine,
                                    child.track_running_stats)
            if child.affine:
                bn.weight, bn.bias = child.weight, child.bias
            if child.track_running_stats:
                bn.running_mean, bn.running_var = child.running_mean, child.running_var
                bn.num_batches_tracked = child.num_batches_tracked
            bn.train(child.training)
            bn.group = group
            setattr(model, name, bn)
        else:
            convert_batchnorm(child, group)
    return model
