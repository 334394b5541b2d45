"""The semantic segmentation trainer, the port of ``holocron_tpu/trainer/segmentation.py``:
a confusion matrix counted on the device gives the global accuracy and the mean IoU."""

import math
from typing import Any, Dict

import torch
from torch import distributed as dist

from ..parallel.sharded import split_of, tag
from .core import Trainer

__all__ = ["SegmentationTrainer"]


class SegmentationTrainer(Trainer):
    """The semantic segmentation trainer (``segmentation.py:19-77``).

    The model returns NCHW logits ``(N, C, H, W)`` (the JAX package's are NHWC); targets
    are ``(N, H, W)`` integer masks, and ``criterion(logits, target)`` takes them so.

    Args:
        num_classes: the classes of the confusion matrix; a target outside ``[0,
            num_classes)`` (the ignored 255) counts in neither
        args, kwargs: :class:`Trainer`'s
    """

    def __init__(self, *args: Any, num_classes: int = 10, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.num_classes = num_classes

    @torch.no_grad()
    def evaluate(self, ignore_index: int = 255) -> Dict[str, float]:
        """``val_loss`` (the mean over the batches whose loss is finite), ``acc_global``
        (the confusion matrix's trace over its sum) and ``mean_iou`` (the mean over every
        class of ``diag / (row + column - diag)``, 0 for a class seen nowhere)
        (``segmentation.py:29-70``). The matrix is one ``torch.bincount`` a batch on the
        device, invalid targets in an overflow bin, and is read once, with the losses; across
        processes each batch is every data-parallel process's, gathered (``_host_batch``);
        under spatial partitioning each process counts its rows and the matrix is
        summed over the spatial group, the loss the global one.
        ``ignore_index`` is kept for the JAX signature: as there, ignored pixels are
        those the criterion ignores and those outside the classes."""
        nc = self.num_classes
        conf = torch.zeros(nc * nc, dtype=torch.int64, device=self.device)
        losses = []
        for x, target in self.val_loader:
            bs = int(x.shape[0])
            out = self._eval_forward(x)
            _, target = self._split_batch(x, target.to(self.device, non_blocking=True))
            rows = split_of(out)  # spatial partitioning: this process's rows of each
            out, target = self._host_batch(out, bs), self._host_batch(target, bs)
            if rows is not None:
                tag(out, rows)
                tag(target, rows._replace(dim=1))
            with self._split_mode():
                losses.append(self.criterion(out, target).float())
            pred, tgt = out.argmax(1).flatten(), target.flatten().long()
            valid = (tgt >= 0) & (tgt < nc)
            inds = torch.where(valid, nc * tgt + pred, nc * nc)  # invalid -> overflow bin
            conf += torch.bincount(inds, minlength=nc * nc + 1)[: nc * nc]
        if self._spatial_group is not None:  # each process counted its rows
            dist.all_reduce(conf, group=self._spatial_group)
        loss_t = torch.stack(losses).double() if losses else torch.zeros(0, dtype=torch.float64, device=self.device)
        readout = torch.cat([conf.double(), loss_t]).cpu()
        conf_mat = readout[: nc * nc].reshape(nc, nc)
        finite = [v for v in readout[nc * nc :].tolist() if math.isfinite(v)]
        diag = conf_mat.diag()
        acc_global = float(diag.sum() / conf_mat.sum().clamp_min(1))
        mean_iou = float((diag / (conf_mat.sum(1) + conf_mat.sum(0) - diag).clamp_min(1)).mean())
        return {"val_loss": sum(finite) / max(len(finite), 1), "acc_global": acc_global, "mean_iou": mean_iou}

    @staticmethod
    def _eval_metrics_str(eval_metrics: Dict[str, float]) -> str:
        return (
            f"Validation loss: {eval_metrics['val_loss']:.4} "
            f"(Acc: {eval_metrics['acc_global']:.2%} | Mean IoU: {eval_metrics['mean_iou']:.2%})"
        )
