"""Batch collation (``holocron_tpu/utils/data/collate.py``): Mixup."""

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Mixup"]


class Mixup:
    """MixUp collate (`Zhang et al. <https://arxiv.org/pdf/1710.09412.pdf>`_,
    ``collate.py:13-57``): one-hot targets, a ``Beta(alpha, alpha)`` mixing factor and a
    batch permutation from a numpy Generator (``seed``), in numpy on the host, as the
    JAX package mixes, so one seed gives both packages the same batch bit for bit.

    uint8 inputs are mixed in float32 and rounded back (``rint``, clipped to 0-255):
    mixing commutes with the normalization applied later on the device. Takes numpy
    arrays or CPU tensors and returns the same kind.

    >>> mix = Mixup(num_classes=10, alpha=0.4)
    >>> images, soft_targets = mix(images, hard_targets)
    """

    def __init__(self, num_classes: int, alpha: float = 0.2, seed: Optional[int] = None) -> None:
        self.num_classes = num_classes
        if alpha < 0:
            raise ValueError("`alpha` only takes positive values")
        self.alpha = alpha
        self._rng = np.random.default_rng(seed)

    def __call__(self, inputs, targets) -> Tuple:
        if isinstance(inputs, torch.Tensor):
            x, y = self._mix(inputs.numpy(), np.asarray(targets))
            return torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))
        return self._mix(np.asarray(inputs), np.asarray(targets))

    def _mix(self, inputs: np.ndarray, targets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        is_u8 = inputs.dtype == np.uint8
        soft_dtype = np.float32 if is_u8 else inputs.dtype
        if targets.ndim == 1:
            if self.num_classes > 1:
                targets = np.eye(self.num_classes, dtype=soft_dtype)[targets]
            elif self.num_classes == 1:
                targets = targets[:, None]
        targets = targets.astype(soft_dtype)

        if self.alpha == 0:
            return inputs, targets
        lam = float(self._rng.beta(self.alpha, self.alpha))
        index = self._rng.permutation(inputs.shape[0])
        if is_u8:
            mixed = lam * inputs.astype(np.float32) + (1 - lam) * inputs[index].astype(np.float32)
            mixed_inputs = np.clip(np.rint(mixed), 0, 255).astype(np.uint8)
        else:
            mixed_inputs = lam * inputs + (1 - lam) * inputs[index]
        mixed_targets = lam * targets + (1 - lam) * targets[index]
        return mixed_inputs, mixed_targets
