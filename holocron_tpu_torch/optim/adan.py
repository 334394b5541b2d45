"""Adan (`Xie et al. <https://arxiv.org/pdf/2208.06677.pdf>`_), the port of
``holocron_tpu/optim/adan.py``: Nesterov momentum on gradient differences with three
EMAs and a decoupled weight-decay divide. As in the JAX package, the previous gradient
is kept every step, as the paper specifies (original Holocron never writes it back)."""

from typing import Iterable, Tuple

import torch

from ._common import LR, bias_correction, f32_sqrt, lr_at

__all__ = ["Adan"]


class Adan(torch.optim.Optimizer):
    """Adan as a ``torch.optim.Optimizer`` (``adan.py:30-78``), with ``torch._foreach``
    ops over each param group and no read of the device in ``step()``.

    ``lr`` is a number or a schedule ``count -> value``, evaluated at the 0-based count
    of the updates this optimizer has applied (the first ``step()`` uses ``lr(0)``);
    each param group keeps its own ``count``. Weight decay is added to the gradient and
    also applied as the divide ``p = (p - lr pt) / (1 + wd lr)``.

    Args:
        params: parameters or param groups (a group may set its own ``weight_decay``)
        lr: learning rate or schedule
        betas: coefficients of the gradient, gradient-difference and squared EMAs
        eps: added to the denominator
        weight_decay: the decay above
        amsgrad: use the running maximum of the squared EMA
    """

    def __init__(
        self,
        params: Iterable,
        lr: LR = 1e-3,
        betas: Tuple[float, float, float] = (0.98, 0.92, 0.99),
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
        defaults = {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay, "amsgrad": amsgrad,
                    "count": 0}
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
        for p in params:
            state = self.state[p]
            if not state:
                for key in ("exp_avg", "exp_avg_diff", "exp_avg_sq", "prev_grad"):
                    state[key] = torch.zeros_like(p)
                if group["amsgrad"]:
                    state["max_exp_avg_sq"] = torch.zeros_like(p)
        m, d, v, prev = ([self.state[p][k] for p in params] for k in ("exp_avg", "exp_avg_diff", "exp_avg_sq",
                                                                      "prev_grad"))
        lr_t = lr_at(group["lr"], group["count"])
        beta1, beta2, beta3 = group["betas"]
        wd = group["weight_decay"]
        count = group["count"] + 1
        bc1, bc2, bc3 = (bias_correction(beta, count) for beta in (beta1, beta2, beta3))
        grads = [p.grad for p in params]
        if wd != 0:
            grads = torch._foreach_add(grads, params, alpha=wd)
        # the JAX package's expressions, term for term (adan.py:52-68)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1 - beta1)
        delta = torch._foreach_sub(grads, prev)
        torch._foreach_mul_(d, beta2)
        torch._foreach_add_(d, delta, alpha=1 - beta2)
        tmp = torch._foreach_add(grads, delta, alpha=beta2)
        torch._foreach_mul_(v, beta3)
        torch._foreach_addcmul_(v, tmp, tmp, value=1 - beta3)
        if group["amsgrad"]:
            v = [self.state[p]["max_exp_avg_sq"] for p in params]
            torch._foreach_maximum_(v, [self.state[p]["exp_avg_sq"] for p in params])
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, f32_sqrt(bc3))
        torch._foreach_add_(denom, group["eps"])
        pt = torch._foreach_div(m, bc1)
        torch._foreach_add_(pt, torch._foreach_div(d, bc2), alpha=beta2)
        torch._foreach_div_(pt, denom)
        torch._foreach_add_(params, pt, alpha=-lr_t)
        if wd != 0:
            torch._foreach_div_(params, 1 + wd * lr_t)
        torch._foreach_copy_(prev, grads)
