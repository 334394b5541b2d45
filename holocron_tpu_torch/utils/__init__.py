"""Host-side utilities (``holocron_tpu/utils``): the reference CLIs' datasets, the native
JPEG decoder, and the image-size finder."""

from . import data
from .misc import find_image_size, parallel

__all__ = ["data", "find_image_size", "parallel"]
