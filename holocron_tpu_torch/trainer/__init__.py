"""Trainers (``holocron_tpu/trainer``), on one device."""

from .classification import ClassificationTrainer
from .core import Trainer
from .utils import freeze_bn, freeze_model, split_normalization_params

__all__ = ["ClassificationTrainer", "Trainer", "freeze_bn", "freeze_model", "split_normalization_params"]
