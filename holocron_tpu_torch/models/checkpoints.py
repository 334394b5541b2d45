"""Checkpoint metadata (``holocron_tpu/models/checkpoints.py``), as plain data.

The same ``default_cfg`` surface: evaluation results, loading meta, preprocessing and
training recipe. ``input_shape`` is channel-first ``(C, H, W)``, the port's layout.
Loading the weights a checkpoint names is not ported yet: the model factories raise on
``pretrained=True``.
"""

from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Checkpoint",
    "Dataset",
    "Evaluation",
    "Interpolation",
    "LoadingMeta",
    "Metric",
    "PreProcessing",
    "TrainingRecipe",
]


class Interpolation(str, Enum):
    """Resize interpolation mode."""

    NEAREST = "nearest"
    BILINEAR = "bilinear"
    BICUBIC = "bicubic"


@dataclass
class TrainingRecipe:
    """How a checkpoint was produced (``checkpoints.py:37-42``)."""

    commit: Optional[str]
    script: Optional[str]
    args: Optional[str]


class Metric(str, Enum):
    """Evaluation metric (``checkpoints.py:45-49``)."""

    TOP1_ACC = "top1-accuracy"
    TOP5_ACC = "top5-accuracy"


class Dataset(str, Enum):
    """Training/evaluation dataset (``checkpoints.py:52-57``)."""

    IMAGENET1K = "imagenet-1k"
    IMAGENETTE = "imagenette"
    CIFAR10 = "cifar10"


@dataclass
class Evaluation:
    """Results of model evaluation."""

    dataset: Dataset
    results: Dict[Metric, float]


@dataclass
class LoadingMeta:
    """Metadata to load the model."""

    url: str
    sha256: str
    size: int
    arch: str
    num_params: int
    categories: List[str]


@dataclass
class PreProcessing:
    """Preprocessing metadata. ``input_shape`` is channel-first ``(C, H, W)``."""

    input_shape: Tuple[int, ...]
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    interpolation: Interpolation = Interpolation.BILINEAR


@dataclass
class Checkpoint:
    """Everything required to run a model exactly as evaluated (``checkpoints.py:91-98``)."""

    evaluation: Evaluation
    meta: LoadingMeta
    pre_processing: PreProcessing
    recipe: TrainingRecipe
