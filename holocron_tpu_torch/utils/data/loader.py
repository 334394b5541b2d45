"""Datasets of the reference CLIs (``holocron_tpu/utils/data/loader.py``), for
``torch.utils.data.DataLoader``: samples are channel-first float32 tensors."""

from typing import Any, Sequence, Tuple

import numpy as np
import torch

__all__ = ["SyntheticDataset", "normalize_image"]


def normalize_image(img: Any, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """A uint8 HWC image (PIL or array) as a float32 CHW tensor, ``(x / 255 - mean) / std``
    (``loader.py:45-48``)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))


class SyntheticDataset:
    """Random samples for smoke tests and ``--check-setup`` runs without data
    (``loader.py:84-112``): sample ``idx`` is drawn from ``np.random.default_rng(idx)``
    as the JAX package draws it (so both packages see the same samples; ``seed`` does
    not enter the draws there either), the image transposed to channel-first.

    Args:
        num_samples: the dataset's length
        shape: the image's ``(C, H, W)``
        num_classes: the classes the targets take
        task: ``classification`` (an int), ``segmentation`` (an ``(H, W)`` int64 mask)
            or ``detection`` (a dict of relative xyxy ``boxes`` and ``labels``)
    """

    def __init__(self, num_samples: int = 128, shape: Tuple[int, int, int] = (3, 224, 224), num_classes: int = 10,
                 task: str = "classification", seed: int = 0) -> None:
        if task not in ("classification", "segmentation", "detection"):
            raise ValueError(f"unknown task: {task}")
        self.num_samples, self.shape, self.num_classes, self.task, self.seed = (
            num_samples, tuple(shape), num_classes, task, seed)
        self._cache = {}

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        if idx not in self._cache:
            rng = np.random.default_rng(idx)
            c, h, w = self.shape
            img = torch.from_numpy(np.ascontiguousarray(rng.normal(size=(h, w, c)).astype(np.float32).transpose(2, 0, 1)))
            if self.task == "classification":
                tgt = int(rng.integers(0, self.num_classes))
            elif self.task == "segmentation":
                tgt = torch.from_numpy(rng.integers(0, self.num_classes, size=(h, w)).astype(np.int64))
            else:
                n = int(rng.integers(1, 4))
                boxes = np.sort(rng.random((n, 2, 2)), axis=1).transpose(0, 2, 1).reshape(n, 4).astype(np.float32)
                tgt = {"boxes": boxes[:, [0, 2, 1, 3]], "labels": rng.integers(0, self.num_classes, size=(n,))}
            self._cache[idx] = (img, tgt)
        return self._cache[idx]
