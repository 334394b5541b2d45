"""Host-side utilities (``holocron_tpu/utils``): the reference CLIs' datasets, the native
JPEG decoder, the image-size finder, and device time by operation."""

from . import data, profiling
from .misc import find_image_size, parallel

__all__ = ["data", "find_image_size", "parallel", "profiling"]
