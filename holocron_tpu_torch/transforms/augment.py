"""The training recipe's augmentations (``holocron_tpu/transforms/augment.py``):
RandomResizedCrop, RandomHorizontalFlip, TrivialAugmentWide, normalization, then
RandomErasing (original Holocron's ``references/classification/train.py:100-108``).

They run on the host, in numpy and PIL, like the JAX package's, and draw from a
``np.random.Generator`` in the same order, so one seed gives both packages the same
images bit for bit. Each takes a PIL image or an ``(H, W, C)`` numpy array and returns
the same kind, except :class:`RandomErasing`, which (applied after normalization, or on
uint8 with ``pixel_stats``) takes a numpy array. An array is resized by the port's
:func:`~holocron_tpu_torch.transforms.interpolation._resize`.
"""

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .interpolation import _get_image_shape, _resize

__all__ = ["Compose", "RandomErasing", "RandomHorizontalFlip", "RandomResizedCrop", "TrivialAugmentWide"]


def _crop(image, top: int, left: int, h: int, w: int):
    if isinstance(image, np.ndarray):
        return image[top : top + h, left : left + w]
    return image.crop((left, top, left + w, top + h))


class RandomHorizontalFlip:
    """Flips the image horizontally with probability ``p`` (torchvision semantics)."""

    def __init__(self, p: float = 0.5, seed: Optional[int] = None) -> None:
        self.p = p
        self._rng = np.random.default_rng(seed)

    def __call__(self, image, rng=None):
        rng = self._rng if rng is None else rng
        if float(rng.random()) >= self.p:
            return image
        if isinstance(image, np.ndarray):
            return np.ascontiguousarray(image[:, ::-1])
        from PIL import Image

        return image.transpose(Image.FLIP_LEFT_RIGHT)


class RandomResizedCrop:
    """Random area/aspect crop resized to ``size`` — the recipe's first op
    (reference references/classification/train.py:102, torchvision semantics:
    10 sampling attempts, center-crop fallback).
    """

    def __init__(
        self,
        size: int,
        scale: Tuple[float, float] = (0.08, 1.0),
        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
        interpolation: str = "bilinear",
        seed: Optional[int] = None,
    ) -> None:
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        if scale[0] > scale[1] or ratio[0] > ratio[1]:
            raise ValueError("scale and ratio should be of kind (min, max)")
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.interpolation = interpolation
        self._rng = np.random.default_rng(seed)

    def get_params(self, image, rng=None) -> Tuple[int, int, int, int]:
        rng = self._rng if rng is None else rng
        height, width = _get_image_shape(image)
        area = height * width
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * float(rng.uniform(*self.scale))
            aspect = math.exp(float(rng.uniform(*log_ratio)))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                top = int(rng.integers(0, height - h + 1))
                left = int(rng.integers(0, width - w + 1))
                return top, left, h, w
        # fallback: center crop at the closest in-range aspect ratio
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            w, h = width, int(round(width / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            h, w = height, int(round(height * self.ratio[1]))
        else:
            w, h = width, height
        return (height - h) // 2, (width - w) // 2, h, w

    def __call__(self, image, rng=None):
        top, left, h, w = self.get_params(image, rng)
        return _resize(_crop(image, top, left, h, w), self.size, self.interpolation)


class TrivialAugmentWide:
    """TrivialAugment with the wide magnitude bins (Mueller & Hutter, 2021) — one op
    drawn uniformly, one strength drawn uniformly, random sign
    (reference references/classification/train.py:104, torchvision
    ``TrivialAugmentWide`` op set and ranges).
    """

    NUM_BINS = 31

    def __init__(self, interpolation: str = "bilinear", seed: Optional[int] = None) -> None:
        self.interpolation = interpolation
        self._rng = np.random.default_rng(seed)
        self._ops = [
            "Identity",
            "ShearX",
            "ShearY",
            "TranslateX",
            "TranslateY",
            "Rotate",
            "Brightness",
            "Color",
            "Contrast",
            "Sharpness",
            "Posterize",
            "Solarize",
            "AutoContrast",
            "Equalize",
        ]

    def _magnitude(self, op: str, rng=None) -> float:
        rng = self._rng if rng is None else rng
        bins = self.NUM_BINS
        idx = int(rng.integers(0, bins))
        # torchvision TrivialAugmentWide magnitude tables
        if op in ("ShearX", "ShearY", "Brightness", "Color", "Contrast", "Sharpness"):
            return 0.99 * idx / (bins - 1)
        if op in ("TranslateX", "TranslateY"):
            return 32.0 * idx / (bins - 1)
        if op == "Rotate":
            return 135.0 * idx / (bins - 1)
        if op == "Posterize":
            return 8 - round(idx / ((bins - 1) / 6))
        if op == "Solarize":
            return 255.0 * (1 - idx / (bins - 1))
        return 0.0

    def __call__(self, image, rng=None):
        rng = self._rng if rng is None else rng
        from PIL import Image, ImageEnhance, ImageOps

        as_array = isinstance(image, np.ndarray)
        if as_array:
            arr = image
            pil = Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
        else:
            pil = image

        op = self._ops[int(rng.integers(0, len(self._ops)))]
        mag = self._magnitude(op, rng)
        if op in ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate", "Brightness", "Color", "Contrast", "Sharpness") and rng.random() < 0.5:
            mag = -mag

        resample = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[
            self.interpolation
        ]
        if op == "Identity":
            out = pil
        elif op == "ShearX":
            out = pil.transform(pil.size, Image.AFFINE, (1, mag, 0, 0, 1, 0), resample)
        elif op == "ShearY":
            out = pil.transform(pil.size, Image.AFFINE, (1, 0, 0, mag, 1, 0), resample)
        elif op == "TranslateX":
            out = pil.transform(pil.size, Image.AFFINE, (1, 0, -mag, 0, 1, 0), resample)
        elif op == "TranslateY":
            out = pil.transform(pil.size, Image.AFFINE, (1, 0, 0, 0, 1, -mag), resample)
        elif op == "Rotate":
            out = pil.rotate(mag, resample)
        elif op == "Brightness":
            out = ImageEnhance.Brightness(pil).enhance(1.0 + mag)
        elif op == "Color":
            out = ImageEnhance.Color(pil).enhance(1.0 + mag)
        elif op == "Contrast":
            out = ImageEnhance.Contrast(pil).enhance(1.0 + mag)
        elif op == "Sharpness":
            out = ImageEnhance.Sharpness(pil).enhance(1.0 + mag)
        elif op == "Posterize":
            out = ImageOps.posterize(pil, int(mag))
        elif op == "Solarize":
            out = ImageOps.solarize(pil, mag)
        elif op == "AutoContrast":
            out = ImageOps.autocontrast(pil)
        else:  # Equalize
            out = ImageOps.equalize(pil)

        if as_array:
            res = np.asarray(out)
            if res.ndim == 2:
                res = res[..., None]
            return res
        return out


class RandomErasing:
    """Erases a random rectangle with probability ``p`` — the recipe's last op,
    applied AFTER normalization on the float array
    (reference references/classification/train.py:107, torchvision semantics with
    ``value="random"``: the patch is filled with standard-normal noise).
    """

    def __init__(
        self,
        p: float = 0.5,
        scale: Tuple[float, float] = (0.02, 0.33),
        ratio: Tuple[float, float] = (0.3, 3.3),
        seed: Optional[int] = None,
        pixel_stats: Optional[Tuple] = None,
    ) -> None:
        if scale[0] > scale[1] or ratio[0] > ratio[1]:
            raise ValueError("scale and ratio should be of kind (min, max)")
        self.p = p
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        # (mean, std) of the normalization applied LATER on-device: lets erasing run
        # on uint8 images (the 4x-lighter transfer path) with a fill that lands on
        # the same standard-normal distribution after normalization
        self.pixel_stats = pixel_stats
        self._rng = np.random.default_rng(seed)

    def __call__(self, image: np.ndarray, rng=None) -> np.ndarray:
        rng = self._rng if rng is None else rng
        if not isinstance(image, np.ndarray):
            raise TypeError("RandomErasing runs after normalization and expects a numpy array")
        if float(rng.random()) >= self.p:
            return image
        h, w = image.shape[0], image.shape[1]
        area = h * w
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            erase_area = area * float(rng.uniform(*self.scale))
            aspect = math.exp(float(rng.uniform(*log_ratio)))
            eh = int(round(math.sqrt(erase_area * aspect)))
            ew = int(round(math.sqrt(erase_area / aspect)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                out = image.copy()
                noise = rng.normal(size=(eh, ew, image.shape[2]))
                if image.dtype == np.uint8:
                    if self.pixel_stats is None:
                        raise ValueError("uint8 erasing needs pixel_stats=(mean, std)")
                    mean, std = (np.asarray(v, np.float32) for v in self.pixel_stats)
                    noise = np.clip(np.rint((mean + std * noise) * 255.0), 0, 255)
                out[top : top + eh, left : left + ew] = noise.astype(image.dtype)
                return out
        return image


class Compose:
    """Chains transforms (the host analog of torchvision ``T.Compose``)."""

    def __init__(self, transforms: Sequence) -> None:
        self.transforms = list(transforms)

    def __call__(self, x):
        for tf in self.transforms:
            x = tf(x)
        return x
