"""Shared helpers of the optimizers (``holocron_tpu/optim/_common.py``)."""

from typing import Callable, Union

import torch

__all__ = ["l2_norm", "lr_at", "safe_local_lr"]

LR = Union[float, Callable[[int], float]]


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x)))


def safe_local_lr(p_norm: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """LARS-style trust ratio ``p_norm / denom``, 1 where either is 0 (the reference's
    fallback for a degenerate case)."""
    degenerate = (p_norm == 0) | (denom == 0)
    return torch.where(degenerate, torch.ones_like(p_norm), p_norm / torch.where(denom == 0, torch.ones_like(denom), denom))


def lr_at(lr: LR, count: int) -> float:
    """A learning rate that may be a schedule (``count -> value``), at ``count``."""
    return lr(count) if callable(lr) else lr
