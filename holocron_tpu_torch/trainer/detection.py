"""The object detection trainer, the port of ``holocron_tpu/trainer/detection.py``: the
step sums the detector's loss dict on padded targets on the device; evaluation assigns
predictions to ground truth by IoU on the host and counts localization,
classification and detection errors.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.boxes import box_iou
from .core import Trainer

__all__ = ["DetectionTrainer", "assign_iou"]


def assign_iou(gt_boxes: np.ndarray, pred_boxes: np.ndarray, iou_threshold: float = 0.5) -> Tuple[List[int], List[int]]:
    """Assigns ground-truth boxes to predictions by IoU (``detection.py:20-37``): each
    box takes its best prediction at ``iou_threshold`` or more; a prediction taken by
    several keeps the box it overlaps most. Returns the box and prediction indices."""
    iou = box_iou(torch.as_tensor(np.asarray(gt_boxes, dtype=np.float32)),
                  torch.as_tensor(np.asarray(pred_boxes, dtype=np.float32))).numpy()
    best = iou.max(axis=1)
    best_idx = iou.argmax(axis=1)
    gt_kept = best >= iou_threshold
    kept_pred = best_idx[gt_kept]
    assign_unique = np.unique(kept_pred)
    if kept_pred.shape[0] == assign_unique.shape[0]:
        return list(np.arange(gt_boxes.shape[0])[gt_kept]), list(kept_pred)
    gt_indices, pred_indices = [], []
    kept_vals = best[gt_kept]
    kept_gt_ids = np.arange(gt_boxes.shape[0])[gt_kept]
    for pred_idx in assign_unique:
        selection = kept_vals[kept_pred == pred_idx].argmax()
        gt_indices.append(int(kept_gt_ids[kept_pred == pred_idx][selection]))
        pred_indices.append(int(pred_idx))
    return gt_indices, pred_indices


class DetectionTrainer(Trainer):
    """The object detection trainer (``detection.py:40-119``), on one device.

    The model is a detector (``models.detection``): ``model(x, target)`` returns its
    loss dict, ``model(x)`` in eval mode its detections. The train loader yields ``(x,
    target)`` with ``target`` padded on the host (:func:`~holocron_tpu_torch.models.detection.pad_targets`,
    ``max_boxes`` 50 in the detection reference); the step moves it to the device
    without reading it back and sums the loss dict in float32. The val loader yields
    ``(x, target)`` with ``target`` the reference's list of ``{boxes, labels}`` dicts.
    ``criterion`` is unused.
    """

    def _loss(self, x: torch.Tensor, target) -> torch.Tensor:
        """The detector's losses on padded device targets, summed in float32
        (``detection.py:48-66``)."""
        losses = self._call_model(self._input_prep(x), self.model.pad(target, self.device))
        return sum(v.float() for v in losses.values())

    @staticmethod
    def _eval_metrics_str(eval_metrics: Dict[str, Optional[float]]) -> str:
        def pct(key: str) -> str:
            return f"{eval_metrics[key]:.2%}" if isinstance(eval_metrics[key], float) else "N/A"

        return f"Loc error: {pct('loc_err')} | Clf error: {pct('clf_err')} | Det error: {pct('det_err')}"

    @torch.no_grad()
    def evaluate(self, iou_threshold: float = 0.5) -> Dict[str, Optional[float]]:
        """The IoU-assignment error rates (``detection.py:74-119``) over the val loader:
        ``loc_err``, ``clf_err`` and ``det_err`` (None where their denominator is 0), and
        ``val_loss``, which is ``loc_err``. The detector's eval forward runs on the batch
        as given (a uint8 batch normalized by ``input_norm``), in float32 as the JAX
        package's ``model(x)``. One process: the all-gather of the counters across hosts
        is not ported."""
        self.model.eval()
        loc_assigns = correct = clf_error = loc_fn = loc_fp = num_samples = 0
        for x, target in self.val_loader:
            detections = self.model(self._normalize(x))
            for dets, t in zip(detections, target):
                t_boxes = np.asarray(t["boxes"])
                d_boxes = np.asarray(dets["boxes"])
                if t_boxes.shape[0] > 0 and d_boxes.shape[0] > 0:
                    gt_indices, pred_indices = assign_iou(t_boxes, d_boxes, iou_threshold)
                    loc_assigns += len(gt_indices)
                    labels = np.asarray(t["labels"])[gt_indices]
                    correct_ = int((labels == np.asarray(dets["labels"])[pred_indices]).sum())
                else:
                    gt_indices, pred_indices, correct_ = [], [], 0
                correct += correct_
                clf_error += len(gt_indices) - correct_
                loc_fn += t_boxes.shape[0] - len(gt_indices)
                loc_fp += d_boxes.shape[0] - len(pred_indices)
            num_samples += sum(np.asarray(t["boxes"]).shape[0] for t in target)

        nb_preds = num_samples - loc_fn + loc_fp
        loc_err = 1 - 2 * loc_assigns / (nb_preds + num_samples) if nb_preds + num_samples > 0 else None
        clf_err = 1 - correct / loc_assigns if loc_assigns > 0 else None
        det_err = 1 - 2 * correct / (nb_preds + num_samples) if nb_preds + num_samples > 0 else None
        return {"loc_err": loc_err, "clf_err": clf_err, "det_err": det_err, "val_loss": loc_err}
