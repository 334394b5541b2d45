"""Trainers (``holocron_tpu/trainer``), on one device."""

from .classification import ClassificationTrainer
from .core import Trainer
from .detection import DetectionTrainer, assign_iou
from .segmentation import SegmentationTrainer
from .utils import freeze_bn, freeze_model, split_normalization_params

__all__ = ["ClassificationTrainer", "DetectionTrainer", "SegmentationTrainer", "Trainer", "assign_iou", "freeze_bn",
           "freeze_model", "split_normalization_params"]
