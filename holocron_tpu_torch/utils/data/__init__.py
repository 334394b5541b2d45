"""Data loading (``holocron_tpu/utils/data``): the synthetic dataset and image
normalization of the reference CLIs, and the native JPEG decoder's binding."""

from ._native import decode_batch_u8, load_native, native_available
from .loader import SyntheticDataset, normalize_image

__all__ = ["SyntheticDataset", "decode_batch_u8", "load_native", "native_available", "normalize_image"]
