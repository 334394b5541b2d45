"""Host-side resizing (``holocron_tpu/transforms/interpolation.py``), on PIL images or
``(H, W, C)`` numpy arrays, as the segmentation CLI's folder reader takes them.

A PIL image is resized by PIL, as in the JAX package. An array is resized as
``jax.image.resize`` resizes it, by ``F.interpolate`` in float32: ``bilinear`` with
half-pixel centers, antialiased when it shrinks (a triangle filter widened by the
scale), and ``nearest`` with half-pixel centers (:func:`_nearest_source`, not torch's
legacy ``nearest``); the result is cast back to the array's dtype as numpy casts (a
float to an integer truncates).
"""

from enum import Enum
from math import sqrt
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

__all__ = ["RandomZoomOut", "Resize", "ResizeMethod"]


class ResizeMethod(str, Enum):
    """``squish`` (a plain resize) or ``pad`` (the aspect kept, then padded)."""

    SQUISH = "squish"
    PAD = "pad"


def _get_image_shape(image) -> Tuple[int, int]:
    if isinstance(image, np.ndarray):
        if image.ndim != 3:
            raise ValueError("the input array is expected to be 3-dimensional (H, W, C)")
        return image.shape[0], image.shape[1]
    if hasattr(image, "size") and hasattr(image, "resize"):  # PIL
        w, h = image.size
        return h, w
    raise TypeError("expected arg 'image' to be a PIL image or a numpy array")


def _nearest_source(m: int, n: int) -> np.ndarray:
    """The source index of each of ``n`` outputs from ``m`` inputs, half-pixel nearest:
    ``floor((i + 0.5) * m / n)``, exactly, in integers. ``jax.image.resize`` evaluates
    it in float32, which lands one lower where the quotient is a whole number and the
    rounding falls below it (none for an odd ``m`` and an even ``n``, as 37 x 53 ->
    256 x 256); ``F.interpolate``'s ``nearest-exact`` rounds at other such points."""
    return (2 * np.arange(n, dtype=np.int64) + 1) * m // (2 * n)


def _resize(image, size: Tuple[int, int], interpolation: str = "bilinear"):
    """``image`` resized to ``(h, w)``, of the same type (``interpolation.py:35-47``)."""
    h, w = size
    if isinstance(image, np.ndarray):
        if interpolation == "nearest":
            rows, cols = _nearest_source(image.shape[0], h), _nearest_source(image.shape[1], w)
            return image.astype(np.float32)[rows][:, cols].astype(image.dtype)
        if interpolation != "bilinear":
            raise ValueError(f"unsupported interpolation for arrays: {interpolation}")
        x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32).transpose(2, 0, 1))[None]
        out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
        return out[0].numpy().transpose(1, 2, 0).astype(image.dtype)
    from PIL import Image

    resample = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[interpolation]
    return image.resize((w, h), resample)


def _pad(image, padding: Tuple[int, int, int, int], pad_mode: str = "constant"):
    """``image`` padded by ``(left, top, right, bottom)``, of the same type
    (``interpolation.py:50-62``)."""
    left, top, right, bottom = padding
    if isinstance(image, np.ndarray):
        np_mode = {"constant": "constant", "edge": "edge", "reflect": "reflect", "symmetric": "symmetric"}[pad_mode]
        return np.pad(image, ((top, bottom), (left, right), (0, 0)), mode=np_mode)
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[..., None]
    padded = _pad(arr, padding, pad_mode)
    from PIL import Image

    return Image.fromarray(padded.squeeze(-1) if padded.shape[-1] == 1 else padded)


class Resize:
    """The flexible resize (``interpolation.py:65-113``): ``squish`` resizes to ``size``;
    ``pad`` keeps the aspect ratio, then pads symmetrically to ``size``.

    >>> tf = Resize((224, 224), mode=ResizeMethod.PAD)
    >>> resized = tf(img)
    """

    def __init__(
        self,
        size: Tuple[int, int],
        mode: ResizeMethod = ResizeMethod.SQUISH,
        pad_mode: str = "constant",
        interpolation: str = "bilinear",
        **kwargs: Any,
    ) -> None:
        if not isinstance(mode, ResizeMethod):
            raise ValueError("mode is expected to be a ResizeMethod")
        if not isinstance(size, (tuple, list)) or len(size) != 2 or any(s <= 0 for s in size):
            raise ValueError("size is expected to be a sequence of 2 positive integers")
        self.size = tuple(size)
        self.mode = mode
        self.pad_mode = pad_mode
        self.interpolation = interpolation

    def get_params(self, image) -> Tuple[int, int]:
        h, w = _get_image_shape(image)
        o_ratio = h / w
        if self.size[0] / self.size[1] > o_ratio:
            return round(self.size[1] * o_ratio), self.size[1]
        return self.size[0], round(self.size[0] / o_ratio)

    def __call__(self, image):
        _get_image_shape(image)  # type validation
        if self.mode == ResizeMethod.SQUISH:
            return _resize(image, self.size, self.interpolation)
        h, w = self.get_params(image)
        img = _resize(image, (h, w), self.interpolation)
        h_pad, w_pad = self.size[0] - h, self.size[1] - w
        padding = (w_pad // 2, h_pad // 2, w_pad - w_pad // 2, h_pad - h_pad // 2)
        return _pad(img, padding, self.pad_mode)


class RandomZoomOut:
    """Random zoom-out (``interpolation.py:107-149``): the image shrunk to a random share
    of the largest area that keeps its aspect ratio inside ``size``, then padded with
    zeros to ``size``. ``scale[0] == 1`` returns the image as it is.

    The share is ``np.random.default_rng(seed)``'s next ``random()`` mapped onto
    ``scale``, one draw a call, as the JAX package draws it.

    >>> tf = RandomZoomOut((224, 224), scale=(0.3, 1.0))
    """

    def __init__(
        self,
        size: Tuple[int, int],
        scale: Tuple[float, float] = (0.5, 1.0),
        interpolation: str = "bilinear",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(size, (tuple, list)) or len(size) != 2 or any(s <= 0 for s in size):
            raise ValueError("size is expected to be a sequence of 2 positive integers")
        if len(scale) != 2 or scale[0] > scale[1]:
            raise ValueError("scale is expected to be a couple of floats, the first one being small than the second")
        self.size = tuple(size)
        self.scale = tuple(scale)
        self.interpolation = interpolation
        self._rng = np.random.default_rng(seed)

    def get_params(self, image) -> Tuple[int, int]:
        h, w = _get_image_shape(image)
        scale = (self.scale[1] - self.scale[0]) * float(self._rng.random()) + self.scale[0]
        aratio = h / w
        tratio = self.size[0] / self.size[1]
        max_area = self.size[1] ** 2 * aratio if tratio > aratio else self.size[0] ** 2 / aratio
        area = max_area * scale
        w_ = round(sqrt(area / aratio))
        h_ = round(area / w_)
        return h_, w_

    def __call__(self, image):
        if self.scale[0] == 1:
            return image
        h, w = self.get_params(image)
        img = _resize(image, (h, w), self.interpolation)
        h_delta, w_delta = self.size[0] - h, self.size[1] - w
        padding = (w_delta // 2, h_delta // 2, w_delta - w_delta // 2, h_delta - h_delta // 2)
        return _pad(img, padding)
