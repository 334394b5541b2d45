"""Box-aware transformations for object detection, the port of
``references/detection/transforms.py``: on PIL images or ``(H, W, C)`` numpy arrays, with
targets ``{"boxes": (N, 4) float32 xyxy in absolute pixels, "labels": (N,)}``.

Each transform is called as ``tf(image, target, rng=None)``. Only
:class:`RandomHorizontalFlip` draws, from ``rng`` when one is given (the detection CLI
gives each sample its own, from ``(seed, epoch, index)``), else from its own generator
(the JAX package's behaviour).
"""

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ...transforms.interpolation import _get_image_shape, _resize

__all__ = [
    "CenterCrop",
    "Compose",
    "ImageTransform",
    "RandomHorizontalFlip",
    "Resize",
    "VOCTargetTransform",
    "convert_to_relative",
]

Target = Dict[str, Any]


def _size(size) -> Tuple[int, int]:
    return tuple(size) if isinstance(size, (tuple, list)) else (size, size)


class VOCTargetTransform:
    """A VOC annotation dict parsed into ``{boxes, labels}`` arrays (``transforms.py:22-39``)."""

    def __init__(self, classes: Sequence[str]) -> None:
        self.class_map = {label: idx for idx, label in enumerate(classes)}

    def __call__(self, image, target: Target, rng: Optional[np.random.Generator] = None):
        objs = target["annotation"]["object"]
        boxes = np.asarray(
            [[int(o["bndbox"][k]) for k in ("xmin", "ymin", "xmax", "ymax")] for o in objs], dtype=np.float32
        ).reshape(-1, 4)
        labels = np.asarray([self.class_map[o["name"]] for o in objs], dtype=np.int64)
        return image, {"boxes": boxes, "labels": labels}


class Compose:
    """The transforms in turn, ``rng`` handed to each (``transforms.py:42-49``)."""

    def __init__(self, transforms: Sequence) -> None:
        self.transforms = transforms

    def __call__(self, image, target: Target, rng: Optional[np.random.Generator] = None):
        for t in self.transforms:
            image, target = t(image, target, rng=rng)
        return image, target


class ImageTransform:
    """An image-only transform; the target passes through (``transforms.py:52-60``)."""

    def __init__(self, transform) -> None:
        self.transform = transform

    def __call__(self, image, target: Target, rng: Optional[np.random.Generator] = None):
        return self.transform(image), target


class Resize:
    """The image and its boxes resized to ``size`` ``(h, w)`` (``transforms.py:63-75``)."""

    def __init__(self, size, interpolation: str = "bilinear") -> None:
        self.size = _size(size)
        self.interpolation = interpolation

    def __call__(self, image, target: Target, rng: Optional[np.random.Generator] = None):
        h, w = _get_image_shape(image)
        boxes = np.array(target["boxes"], dtype=np.float32)
        boxes[:, [0, 2]] *= self.size[1] / w
        boxes[:, [1, 3]] *= self.size[0] / h
        return _resize(image, self.size, self.interpolation), {**target, "boxes": boxes}


class CenterCrop:
    """A centre crop to ``size`` ``(h, w)``, the boxes clamped to it (``transforms.py:78-96``)."""

    def __init__(self, size) -> None:
        self.size = _size(size)

    def __call__(self, image, target: Target, rng: Optional[np.random.Generator] = None):
        h, w = _get_image_shape(image)
        ch, cw = self.size
        y = int(h / 2 - ch / 2)
        x = int(w / 2 - cw / 2)
        if isinstance(image, np.ndarray):
            image = image[y : y + ch, x : x + cw]
        else:
            image = image.crop((x, y, x + cw, y + ch))
        boxes = np.array(target["boxes"], dtype=np.float32)
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], x, x + cw) - x
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], y, y + ch) - y
        return image, {**target, "boxes": boxes}


class RandomHorizontalFlip:
    """The image and its boxes flipped with probability ``p`` (``transforms.py:99-118``):
    one ``random()`` draw a call, from ``rng`` when given, else from
    ``np.random.default_rng(seed)``."""

    def __init__(self, p: float = 0.5, seed: Optional[int] = None) -> None:
        self.p = p
        self._rng = np.random.default_rng(seed)

    def __call__(self, image, target: Target, rng: Optional[np.random.Generator] = None):
        if (rng or self._rng).random() < self.p:
            h, w = _get_image_shape(image)
            if isinstance(image, np.ndarray):
                image = np.ascontiguousarray(image[:, ::-1])
            else:
                from PIL import Image

                image = image.transpose(Image.FLIP_LEFT_RIGHT)
            boxes = np.array(target["boxes"], dtype=np.float32)
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
            target = {**target, "boxes": boxes}
        return image, target


def convert_to_relative(image, target: Target):
    """Boxes divided by the image's width and height, clipped to [0, 1] (``transforms.py:121-127``)."""
    h, w = _get_image_shape(image)
    boxes = np.array(target["boxes"], dtype=np.float32)
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] / w, 0, 1)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] / h, 0, 1)
    return image, {**target, "boxes": boxes}
