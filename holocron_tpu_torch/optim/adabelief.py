"""AdaBelief (`Zhuang et al. <https://arxiv.org/pdf/2010.07468.pdf>`_), the port of
``holocron_tpu/optim/adabelief.py``: Adam whose second moment is that of the gradient's
residual from its first moment, ``(g - m)^2``, in place of ``g^2``."""

import math
from typing import Iterable, Tuple

import torch

from ._common import LR, lr_at

__all__ = ["AdaBelief"]


class AdaBelief(torch.optim.Optimizer):
    """AdaBelief as a ``torch.optim.Optimizer`` (``adabelief.py:25-63``), per parameter.

    ``lr`` is a number or a schedule ``count -> value`` evaluated at the 0-based count of
    the updates this optimizer has applied (the optax convention: the first ``step()``
    uses ``lr(0)``); each param group keeps its own ``count``.

    Args:
        params: parameters or param groups (a group may set its own ``weight_decay``)
        lr: learning rate or schedule
        betas: moment coefficients
        eps: added to the denominator
        weight_decay: L2 decay, added to the gradient
        amsgrad: use the running maximum of the second moment
    """

    def __init__(
        self,
        params: Iterable,
        lr: LR = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
    ) -> None:
        if not callable(lr) and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if eps < 0.0:
            raise ValueError(f"Invalid epsilon value: {eps}")
        for i, beta in enumerate(betas):
            if not 0.0 <= beta < 1.0:
                raise ValueError(f"Invalid beta parameter at index {i}: {beta}")
        defaults = {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay, "amsgrad": amsgrad, "count": 0}
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr_t = lr_at(group["lr"], group["count"])
            beta1, beta2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            count = group["count"] + 1
            bc1, bc2 = 1.0 - beta1**count, 1.0 - beta2**count
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_var"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        state["max_exp_avg_var"] = torch.zeros_like(p)
                # the JAX package's expressions, term for term (adabelief.py:46-57)
                m, v = state["exp_avg"], state["exp_avg_var"]
                grad = p.grad + wd * p if wd != 0 else p.grad
                m.copy_(beta1 * m + (1 - beta1) * grad)
                residual = grad - m
                v.copy_(beta2 * v + (1 - beta2) * residual * residual)
                if group["amsgrad"]:
                    torch.maximum(state["max_exp_avg_var"], v, out=state["max_exp_avg_var"])
                    v = state["max_exp_avg_var"]
                p.add_(-(lr_t / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2) + eps))
            group["count"] = count
        return loss
