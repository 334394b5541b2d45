from . import boxes
from .boxes import *  # noqa: F403

__all__ = [
    "aspect_ratio",
    "aspect_ratio_consistency",
    "box_area",
    "box_giou",
    "box_iou",
    "ciou_loss",
    "diou_loss",
    "iou_penalty",
]
