"""TAdam (`Ilboudo et al. <https://arxiv.org/pdf/2003.00179.pdf>`_), the port of
``holocron_tpu/optim/tadam.py``: Adam with a Student-t robust first moment. Each
parameter's step weighs its gradient by ``w_t``, built from the gradient's normalized
deviation from the first moment, and accumulates the weights in a scalar ``W_t``
(starting at ``beta1 / (1 - beta1)``).
"""

from typing import Iterable, Optional, Tuple

import torch

from ._common import LR, lr_at

__all__ = ["TAdam"]


class TAdam(torch.optim.Optimizer):
    """TAdam as a ``torch.optim.Optimizer`` (``tadam.py:27-73``), per parameter.

    ``lr`` is a number or a schedule ``count -> value`` evaluated at the 0-based count of
    the updates this optimizer has applied (the optax convention: the first ``step()``
    uses ``lr(0)``); each param group keeps its own ``count``.

    Args:
        params: parameters or param groups (a group may set its own ``weight_decay``)
        lr: learning rate or schedule
        betas: moment coefficients
        eps: added to the second moment in ``w_t`` and to the denominator
        weight_decay: L2 decay, added to the gradient
        amsgrad: use the running maximum of the second moment
        dof: the Student-t degrees of freedom; the parameter's size when None
    """

    def __init__(
        self,
        params: Iterable,
        lr: LR = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        dof: Optional[float] = None,
    ) -> None:
        if not callable(lr) and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if eps < 0.0:
            raise ValueError(f"Invalid epsilon value: {eps}")
        for i, beta in enumerate(betas):
            if not 0.0 <= beta < 1.0:
                raise ValueError(f"Invalid beta parameter at index {i}: {beta}")
        defaults = {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay, "amsgrad": amsgrad,
                    "dof": dof, "count": 0}
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
                    state["exp_avg_sq"] = torch.zeros_like(p)
                    state["big_w"] = torch.full((), beta1 / (1 - beta1), dtype=torch.float32, device=p.device)
                    if group["amsgrad"]:
                        state["max_exp_avg_sq"] = torch.zeros_like(p)
                # the JAX package's expressions, term for term (tadam.py:52-68)
                m, v, big_w = state["exp_avg"], state["exp_avg_sq"], state["big_w"]
                d = float(p.numel()) if group["dof"] is None else group["dof"]
                grad = p.grad + wd * p if wd != 0 else p.grad
                w_t = torch.sum(torch.square(grad - m) / (v + eps))
                w_t = (d + p.numel()) / (w_t + d)
                new_m = m * (big_w / (big_w + w_t)) + (w_t * grad) / (big_w + w_t)
                big_w.copy_(big_w * (2 * beta1 - 1) / beta1 + w_t)
                v.copy_(beta2 * v + (1 - beta2) * grad * grad)
                m.copy_(new_m)
                if group["amsgrad"]:
                    torch.maximum(state["max_exp_avg_sq"], v, out=state["max_exp_avg_sq"])
                    v = state["max_exp_avg_sq"]
                denom = torch.sqrt(v) / bc2**0.5 + eps
                p.add_(-(lr_t / bc1) * new_m / denom)
            group["count"] = count
        return loss
