"""AdEMAMix (`Pagliardini et al. <https://arxiv.org/pdf/2409.03137.pdf>`_), the port of
``holocron_tpu/optim/ademamix.py``: Adam whose first moment mixes a fast EMA (beta1,
bias-corrected) and a slow one (beta3, not bias-corrected) weighted by ``alpha``."""

from typing import Iterable, Tuple

import torch

from ._common import LR, bias_correction, f32_sqrt, lr_at

__all__ = ["AdEMAMix"]


class AdEMAMix(torch.optim.Optimizer):
    """AdEMAMix as a ``torch.optim.Optimizer`` (``ademamix.py:25-58``), with
    ``torch._foreach`` ops over each param group and no read of the device in ``step()``.

    ``lr`` is a number or a schedule ``count -> value``, evaluated at the 0-based count
    of the updates this optimizer has applied (the first ``step()`` uses ``lr(0)``);
    each param group keeps its own ``count``.

    Args:
        params: parameters or param groups (a group may set its own ``weight_decay``)
        lr: learning rate or schedule
        betas: coefficients of the fast EMA, the squared EMA and the slow EMA
        alpha: weight of the slow EMA
        eps: added to the denominator
        weight_decay: L2 decay, added to the gradient
    """

    def __init__(
        self,
        params: Iterable,
        lr: LR = 1e-3,
        betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
        alpha: float = 5.0,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
    ) -> None:
        if not callable(lr) and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if eps < 0.0:
            raise ValueError(f"Invalid epsilon value: {eps}")
        for i, beta in enumerate(betas):
            if not 0.0 <= beta < 1.0:
                raise ValueError(f"Invalid beta parameter at index {i}: {beta}")
        defaults = {"lr": lr, "betas": betas, "alpha": alpha, "eps": eps, "weight_decay": weight_decay, "count": 0}
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
            if not self.state[p]:
                self.state[p].update({k: torch.zeros_like(p) for k in ("exp_avg_fast", "exp_avg_slow", "exp_avg_sq")})
        m1, m2, v = ([self.state[p][k] for p in params] for k in ("exp_avg_fast", "exp_avg_slow", "exp_avg_sq"))
        lr_t = lr_at(group["lr"], group["count"])
        beta1, beta2, beta3 = group["betas"]
        count = group["count"] + 1
        bc1, bc2 = bias_correction(beta1, count), bias_correction(beta2, count)
        grads = [p.grad for p in params]
        if group["weight_decay"] != 0:
            grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
        # the JAX package's expressions, term for term (ademamix.py:45-51)
        torch._foreach_mul_(m1, beta1)
        torch._foreach_add_(m1, grads, alpha=1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
        torch._foreach_mul_(m2, beta3)
        torch._foreach_add_(m2, grads, alpha=1 - beta3)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, f32_sqrt(bc2))
        torch._foreach_add_(denom, group["eps"])
        num = torch._foreach_div(m1, bc1)
        torch._foreach_add_(num, m2, alpha=group["alpha"])
        torch._foreach_mul_(num, -lr_t)
        torch._foreach_div_(num, denom)
        torch._foreach_add_(params, num)
