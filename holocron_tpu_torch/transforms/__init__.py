"""Host-side transforms (``holocron_tpu/transforms``): so far the resize of the
segmentation CLI's folder reader."""

from .interpolation import Resize, ResizeMethod

__all__ = ["Resize", "ResizeMethod"]
