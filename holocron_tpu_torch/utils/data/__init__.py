"""Data loading (``holocron_tpu/utils/data``): so far the native JPEG decoder's binding."""

from ._native import decode_batch_u8, load_native, native_available

__all__ = ["decode_batch_u8", "load_native", "native_available"]
