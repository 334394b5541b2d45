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
from .sharded import _batch_norm_over, gather, local_view, split_of, tag

__all__ = ["CrossProcessBatchNorm2d", "CrossProcessFlaxBatchNorm2d", "convert_batchnorm"]


class CrossProcessBatchNorm2d(nn.BatchNorm2d):
    """A batch norm whose training forward takes its statistics over every process's
    batch (``group``; every process by default): the mean from the summed per-channel
    sums and counts, then the biased variance from the summed squared deviations (two
    passes, as torch's), each sum a differentiable all-reduce (its backward sums the
    gradients over the processes), in float32; the output in the input's dtype. Under
    spatial partitioning each process holds rows of every image and the sums cover
    them; under tensor parallelism each holds its block of the channels. The running statistics move as those of
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
        factor = 0.0
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
            factor = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        # under tensor parallelism this rank's channels, split as its parameters; under
        # spatial partitioning this rank's rows, the group's sums covering every row
        ps, xs = split_of(self.running_mean if self.weight is None else self.weight), split_of(x)
        if ps is not None and (xs is None or not (xs.same(ps) and xs.dim == 1)):
            x = local_view(gather(x), ps._replace(dim=1))
        elif ps is None and xs is not None and xs.kind == "channels":
            x = gather(x)
        y = _batch_norm_over(x, self.running_mean if self.track_running_stats else None,
                             self.running_var if self.track_running_stats else None, self.weight, self.bias,
                             True, factor, self.eps, group, self.flax_running_var)
        return tag(y, split_of(x))


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
