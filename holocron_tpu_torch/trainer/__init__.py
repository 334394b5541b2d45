"""Trainers (``holocron_tpu/trainer``), one device a process."""

from .classification import BinaryClassificationTrainer, ClassificationTrainer
from .core import Trainer
from .detection import DetectionTrainer, assign_iou
from .segmentation import SegmentationTrainer
from .utils import freeze_bn, freeze_model, split_normalization_params

__all__ = ["BinaryClassificationTrainer", "ClassificationTrainer", "DetectionTrainer", "SegmentationTrainer", "Trainer",
           "assign_iou", "freeze_bn", "freeze_model", "split_normalization_params"]
