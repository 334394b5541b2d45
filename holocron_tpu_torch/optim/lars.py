"""LARS (`You et al. <https://arxiv.org/pdf/1708.03888.pdf>`_), the port of
``holocron_tpu/optim/lars.py``: SGD with momentum, each parameter's step scaled by the
trust ratio ``||p|| / (||g|| + wd ||p||)`` (1 where either is 0)."""

from typing import Iterable

import torch

from ._common import LR, lr_at, safe_local_lr

__all__ = ["LARS"]


class LARS(torch.optim.Optimizer):
    """LARS as a ``torch.optim.Optimizer`` (``lars.py:24-66``), with ``torch._foreach``
    ops over each param group and no read of the device in ``step()``.

    ``lr`` is a number or a schedule ``count -> value``, evaluated at the 0-based count
    of the updates this optimizer has applied (the optax convention: the first
    ``step()`` uses ``lr(0)``); each param group keeps its own ``count``. The momentum
    buffer starts as the first step's raw ``d_p = g + wd p``, as torch's SGD seeds it.

    Args:
        params: parameters or param groups (a group may set its own ``weight_decay``)
        lr: learning rate or schedule
        momentum: momentum factor
        dampening: dampening of the momentum
        weight_decay: L2 decay, added to the gradient and to the trust ratio's denominator
        nesterov: Nesterov momentum (needs a momentum and zero dampening)
    """

    def __init__(
        self,
        params: Iterable,
        lr: LR = 1e-3,
        momentum: float = 0.0,
        dampening: float = 0.0,
        weight_decay: float = 0.0,
        nesterov: bool = False,
    ) -> None:
        if not callable(lr) and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if momentum < 0.0:
            raise ValueError(f"Invalid momentum value: {momentum}")
        if weight_decay < 0.0:
            raise ValueError(f"Invalid weight_decay value: {weight_decay}")
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero dampening")
        defaults = {"lr": lr, "momentum": momentum, "dampening": dampening, "weight_decay": weight_decay,
                    "nesterov": nesterov, "count": 0}
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params)
            group["count"] += 1
        return loss

    def _update(self, group: dict, params: list) -> None:
        grads = [p.grad for p in params]
        lr_t = lr_at(group["lr"], group["count"])
        wd, momentum = group["weight_decay"], group["momentum"]
        # the trust ratio of every parameter at once, on the device
        p_norm = torch.stack(torch._foreach_norm(params))
        denom = torch.stack(torch._foreach_norm(grads)) + wd * p_norm
        scale = (-lr_t * safe_local_lr(p_norm, denom)).unbind()
        d_p = torch._foreach_add(grads, params, alpha=wd)
        if momentum != 0:
            for p in params:
                if not self.state[p]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(p)
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            if group["count"] == 0:
                torch._foreach_copy_(bufs, d_p)
            else:
                torch._foreach_mul_(bufs, momentum)
                torch._foreach_add_(bufs, d_p, alpha=1 - group["dampening"])
            d_p = torch._foreach_add(d_p, bufs, alpha=momentum) if group["nesterov"] else bufs
        torch._foreach_add_(params, torch._foreach_mul(d_p, scale))
