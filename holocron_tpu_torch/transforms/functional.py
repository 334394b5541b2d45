"""Batch preprocessing (``holocron_tpu/transforms/functional.py``): the host-side
space-to-depth rearrange, and the resize-and-normalize of a uint8 batch as torch ops on
the batch's device."""

from typing import Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

__all__ = ["fused_preprocess", "space_to_depth_batch"]


def space_to_depth_batch(images, scale: int = 2) -> np.ndarray:
    """Host-side space-to-depth (``functional.py:19-37``): numpy ``(N, H, W, C)`` ->
    ``(N, H/s, W/s, s*s*C)``, channels in ``(sh, sw, c)`` order, as
    :func:`~holocron_tpu_torch.nn.functional.concat_downsample2d` lays them out. uint8
    and float batches alike."""
    x = np.asarray(images)
    n, h, w, c = x.shape
    s = scale
    if h % s or w % s:
        raise ValueError("spatial size must be a multiple of scale")
    x = x.reshape(n, h // s, s, w // s, s, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(n, h // s, w // s, s * s * c))


def fused_preprocess(
    images: torch.Tensor,
    size: Tuple[int, int],
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """A uint8 ``(N, H, W, C)`` batch as the normalized model input
    (``functional.py:40-53``), on its device: ``x / 255``, resized bilinearly to
    ``size`` as ``jax.image.resize`` resizes (half-pixel centres, antialiased when it
    shrinks), then ``(x - mean) / std`` in float32, cast to ``dtype``. Returned NCHW in
    the channels-last memory format (the port's layout; the JAX package's is NHWC)."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    return ((x - mean_t) / std_t).to(dtype).contiguous(memory_format=torch.channels_last)
