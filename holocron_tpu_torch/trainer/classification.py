"""Classification trainers (``holocron_tpu/trainer/classification.py``)."""

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import Trainer

__all__ = ["BinaryClassificationTrainer", "ClassificationTrainer"]


class ClassificationTrainer(Trainer):
    """Image classification trainer (``classification.py:18-135``)."""

    is_binary: bool = False

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

    def _sample_losses(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The criterion a sample: a criterion with a ``reduction`` attribute is called
        with ``"none"``, any other is taken to return one loss a sample."""
        reduction = getattr(self.criterion, "reduction", None)
        if reduction is None:
            return self.criterion(logits, target)
        self.criterion.reduction = "none"
        try:
            return self.criterion(logits, target)
        finally:
            self.criterion.reduction = reduction

    @torch.no_grad()
    def top_losses(self, mean: Sequence[float], std: Sequence[float], num_samples: int = 12) -> Dict[str, Any]:
        """The ``num_samples`` training samples of highest loss, from a streaming top-k
        over the training set (``classification.py:84-136``), highest first:
        ``losses``, ``preds`` (the argmax, multi-class), ``probs`` (the top
        probability, or the sigmoid for a binary trainer), ``targets`` and ``images``
        (HWC, unnormalized by ``mean`` and ``std``, clipped to [0, 1]), as numpy. The
        model runs on the device in eval mode; the losses, probabilities and the kept
        images are read back a batch at a time."""
        losses = np.zeros(num_samples, dtype=np.float32)
        preds = np.zeros(num_samples, dtype=int)
        probs = np.zeros(num_samples, dtype=np.float32)
        targets = np.zeros(num_samples, dtype=np.float32 if self.is_binary else int)
        images = [None] * num_samples
        for x, target in self.train_loader:
            logits = self._eval_forward(x)
            target_dev = target.to(self.device)
            if self.is_binary:
                target_dev = target_dev.to(logits.dtype).reshape(logits.shape)
            batch_loss = self._sample_losses(logits, target_dev).float()
            if self.is_binary:
                batch_loss = batch_loss.reshape(batch_loss.shape[0], -1).mean(-1)
                probs_ = torch.sigmoid(logits).squeeze(-1)
            else:
                probs_ = torch.softmax(logits, dim=1).amax(dim=1)
            batch_loss, probs_, logits = batch_loss.cpu().numpy(), probs_.cpu().numpy(), logits.cpu().numpy()
            if np.any(batch_loss > losses.min()):
                idcs = np.concatenate((losses, batch_loss)).argsort()[-num_samples:]
                kept_idcs = [idx for idx in idcs if idx < num_samples]
                added_idcs = [idx - num_samples for idx in idcs if idx >= num_samples]
                losses = np.concatenate((losses[kept_idcs], batch_loss[added_idcs]))
                probs = np.concatenate((probs[kept_idcs], probs_[added_idcs]))
                if not self.is_binary:
                    preds = np.concatenate((preds[kept_idcs], logits.argmax(1)[added_idcs]))
                targets = np.concatenate((targets[kept_idcs], np.asarray(target.cpu())[added_idcs]))
                imgs = (np.asarray(x[added_idcs].float().cpu()).transpose(0, 2, 3, 1) * np.asarray(std)
                        + np.asarray(mean))
                images = [images[idx] for idx in kept_idcs] + [np.clip(img, 0, 1) for img in imgs]
        order = losses.argsort()[::-1]
        return {"losses": losses[order], "preds": preds[order], "probs": probs[order], "targets": targets[order],
                "images": [images[idx] for idx in order]}

    def plot_top_losses(
        self,
        mean: Tuple[float, float, float],
        std: Tuple[float, float, float],
        classes: Optional[Sequence[str]] = None,
        num_samples: int = 12,
        **kwargs: Any,
    ) -> None:
        """Shows the samples of :meth:`top_losses` with their loss, prediction and
        target (``classification.py:84-158``); ``kwargs`` go to ``plt.show``."""
        if not self.is_binary and classes is None:
            raise AssertionError("arg 'classes' must be specified for multi-class classification")
        top = self.top_losses(mean, std, num_samples)

        import matplotlib.pyplot as plt

        num_cols = 4
        num_rows = math.ceil(num_samples / num_cols)
        _, axes = plt.subplots(num_rows, num_cols, figsize=(20, 5), squeeze=False)
        rows = zip(top["images"], top["preds"], top["probs"], top["targets"], top["losses"])
        for idx, (img, pred, prob, tgt, loss) in enumerate(rows):
            ax = axes[idx // num_cols][idx % num_cols]
            if img is not None:
                ax.imshow(img)
            if self.is_binary:
                ax.title.set_text(f"{loss:.3} / {prob:.2} / {tgt:.2}")
            else:
                ax.title.set_text(f"{loss:.3} / {classes[pred]} ({prob:.1%}) / {classes[tgt]}")
            ax.axis("off")
        plt.show(**kwargs)


class BinaryClassificationTrainer(ClassificationTrainer):
    """Binary classification trainer (``classification.py:138-175``): the targets are cast
    to the logits' dtype and shape inside the step and the evaluation."""

    is_binary: bool = True

    def _loss(self, x: torch.Tensor, target) -> torch.Tensor:
        out = self._forward(self._input_prep(x))
        return self.criterion(out, target.to(self.device, non_blocking=True).to(out.dtype).reshape(out.shape))

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """The mean loss over the batches whose loss is finite, and the accuracy:
        sigmoid >= 0.5 against target >= 0.5, over ``out[0].numel()`` outputs a sample
        (``classification.py:156-171``)."""
        val_loss, top1, num_samples, num_valid_batches = 0.0, 0.0, 0, 0
        for x, target in self.val_loader:
            out = self._eval_forward(x)
            target = target.to(self.device).to(out.dtype).reshape(out.shape)
            loss = float(self.criterion(out, target))
            if math.isfinite(loss):
                val_loss += loss
                num_valid_batches += 1
            top1 += float(((target >= 0.5) == (torch.sigmoid(out) >= 0.5)).sum()) / out[0].numel()
            num_samples += out.shape[0]
        val_loss /= max(num_valid_batches, 1)
        return {"val_loss": val_loss, "acc": top1 / num_samples}

    @staticmethod
    def _eval_metrics_str(eval_metrics: Dict[str, float]) -> str:
        return f"Validation loss: {eval_metrics['val_loss']:.4} (Acc: {eval_metrics['acc']:.2%})"
