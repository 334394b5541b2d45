"""Host-side transforms (``holocron_tpu/transforms``): the training recipe's
augmentations, the segmentation CLI's resize, the zoom-out of the detection recipe, and
the batch preprocessing."""

from .augment import Compose, RandomErasing, RandomHorizontalFlip, RandomResizedCrop, TrivialAugmentWide
from .functional import fused_preprocess, space_to_depth_batch
from .interpolation import RandomZoomOut, Resize, ResizeMethod

__all__ = ["Compose", "RandomErasing", "RandomHorizontalFlip", "RandomResizedCrop", "RandomZoomOut", "Resize",
           "ResizeMethod", "TrivialAugmentWide", "fused_preprocess", "space_to_depth_batch"]
