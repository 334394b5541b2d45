"""Classification trainer (``holocron_tpu/trainer/classification.py``)."""

import math
from typing import Dict

import torch

from .core import Trainer

__all__ = ["ClassificationTrainer"]


class ClassificationTrainer(Trainer):
    """Image classification trainer (``classification.py:18-55``)."""

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Top-1 and top-5 accuracy (k clamped to the class count) and the mean loss
        over the batches whose loss is finite (``classification.py:23-49``)."""
        val_loss, top1, top5, num_samples, num_valid_batches = 0.0, 0, 0, 0, 0
        for x, target in self.val_loader:
            out = self._eval_forward(x)
            target = target.to(self.device)
            loss = float(self.criterion(out, target))
            if math.isfinite(loss):
                val_loss += loss
                num_valid_batches += 1
            k = min(5, out.shape[1])
            correct = out.topk(k, dim=1).indices == target.reshape(-1, 1)
            top1 += int(correct[:, 0].sum())
            top5 += int(correct.any(dim=1).sum())
            num_samples += out.shape[0]
        val_loss /= max(num_valid_batches, 1)
        return {"val_loss": val_loss, "acc1": top1 / num_samples, "acc5": top5 / num_samples}

    @staticmethod
    def _eval_metrics_str(eval_metrics: Dict[str, float]) -> str:
        return (
            f"Validation loss: {eval_metrics['val_loss']:.4} "
            f"(Acc@1: {eval_metrics['acc1']:.2%}, Acc@5: {eval_metrics['acc5']:.2%})"
        )
