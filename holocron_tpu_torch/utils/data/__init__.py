"""Data loading (``holocron_tpu/utils/data``): the reference CLIs' datasets, batching and
Mixup, and the native JPEG decoder's binding."""

from ._native import (NativeImageFolder, decode_batch, decode_batch_u8, decode_rrc_batch, load_native,
                      native_available, native_collate)
from .cifar import CIFAR10, CIFAR100
from .collate import Mixup
from .loader import (EpochDataLoader, ImageFolder, SyntheticDataset, default_collate, normalize_array,
                     normalize_image, prefetch)

__all__ = ["CIFAR10", "CIFAR100", "EpochDataLoader", "ImageFolder", "Mixup", "NativeImageFolder",
           "SyntheticDataset", "decode_batch", "decode_batch_u8", "decode_rrc_batch", "default_collate",
           "load_native", "native_available", "native_collate", "normalize_array", "normalize_image", "prefetch"]
