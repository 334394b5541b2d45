"""LAMB (`You et al. <https://arxiv.org/pdf/1904.00962.pdf>`_), the port of
``holocron_tpu/optim/lamb.py``: an Adam direction without bias correction, decoupled
weight decay added to it, and the trust ratio ``clip(||p||, *scale_clip) / ||update||``.
"""

from typing import Iterable, Optional, Tuple

import torch

from ._common import LR, l2_norm, lr_at, safe_local_lr

__all__ = ["LAMB"]


class LAMB(torch.optim.Optimizer):
    """LAMB as a ``torch.optim.Optimizer`` (``lamb.py:18-60``).

    ``lr`` is a number or a schedule ``count -> value``, evaluated at the 0-based count
    of the updates this optimizer has applied, as the optax convention has it: the first
    ``step()`` uses ``lr(0)``. Each param group keeps its own ``count``.

    Args:
        params: parameters or param groups (a group may set its own ``weight_decay``)
        lr: learning rate or schedule
        betas: moment coefficients
        eps: added to the root of the second moment
        weight_decay: decoupled weight decay, added to the update before the trust ratio
        scale_clip: bounds of ``||p||`` in the trust ratio, ``(0, 10)`` when None
    """

    def __init__(
        self,
        params: Iterable,
        lr: LR = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        scale_clip: Optional[Tuple[float, float]] = None,
    ) -> None:
        if not callable(lr) and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if eps < 0.0:
            raise ValueError(f"Invalid epsilon value: {eps}")
        for i, beta in enumerate(betas):
            if not 0.0 <= beta < 1.0:
                raise ValueError(f"Invalid beta parameter at index {i}: {beta}")
        defaults = {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay,
                    "scale_clip": scale_clip if scale_clip is not None else (0.0, 10.0), "count": 0}
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
            clip_lo, clip_hi = group["scale_clip"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                # the JAX package's expressions, term for term (lamb.py:42-55)
                mu = beta1 * state["exp_avg"] + (1 - beta1) * g
                nu = beta2 * state["exp_avg_sq"] + (1 - beta2) * g * g
                state["exp_avg"].copy_(mu)
                state["exp_avg_sq"].copy_(nu)
                update = mu / (torch.sqrt(nu) + group["eps"])
                if group["weight_decay"] != 0:
                    update = update + group["weight_decay"] * p
                phi_p = torch.clamp(l2_norm(p), clip_lo, clip_hi)
                local_lr = safe_local_lr(phi_p, l2_norm(update))
                p.add_(-lr_t * local_lr * update)
            group["count"] += 1
        return loss
