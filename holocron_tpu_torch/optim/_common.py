"""Shared helpers of the optimizers (``holocron_tpu/optim/_common.py``)."""

from typing import Callable, Type, Union

import torch

__all__ = ["l2_norm", "lr_at", "safe_local_lr", "scheduled"]

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


def scheduled(optimizer: Type[torch.optim.Optimizer]) -> Type[torch.optim.Optimizer]:
    """``optimizer`` (a ``torch.optim`` class) taking ``lr`` as the port's optimizers take
    it: a number or a schedule ``count -> value``, evaluated before each ``step()`` at
    the 0-based count of the updates applied (each group's ``count``), the optax
    convention."""

    class Scheduled(optimizer):
        def __init__(self, params, lr: LR = 1e-3, **kwargs) -> None:
            super().__init__(params, lr=lr_at(lr, 0), **kwargs)
            for group in self.param_groups:
                group["schedule"], group["count"] = lr, 0

        def step(self, closure=None):
            for group in self.param_groups:
                group["lr"] = lr_at(group["schedule"], group["count"])
            loss = super().step(closure)
            for group in self.param_groups:
                group["count"] += 1
            return loss

    Scheduled.__name__ = Scheduled.__qualname__ = optimizer.__name__
    return Scheduled
