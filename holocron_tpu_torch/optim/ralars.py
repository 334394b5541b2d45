"""RaLars, the port of ``holocron_tpu/optim/ralars.py``: RAdam's rectified step
(`Liu et al. <https://arxiv.org/pdf/1908.03265.pdf>`_) scaled by a LARS trust ratio
``clip(||p||, *scale_clip) / ||update||``."""

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ._common import LR, bias_correction, lr_at, safe_local_lr

__all__ = ["RaLars"]


class RaLars(torch.optim.Optimizer):
    """RaLars as a ``torch.optim.Optimizer`` (``ralars.py:16-66``), with
    ``torch._foreach`` ops over each param group and no read of the device in ``step()``.

    ``lr`` is a number or a schedule ``count -> value``, evaluated at the 0-based count
    of the updates this optimizer has applied (the first ``step()`` uses ``lr(0)``);
    each param group keeps its own ``count``. The rectification depends on the count
    alone, so its branch is taken on the host.

    Args:
        params: parameters or param groups (a group may set its own ``weight_decay``)
        lr: learning rate or schedule
        betas: moment coefficients
        eps: added to the root of the second moment
        weight_decay: decoupled weight decay, added to the update before the trust ratio
        force_adaptive_momentum: take the adaptive step before the rectification holds
        scale_clip: bounds of ``||p||`` in the trust ratio, ``(0, 10)`` when None
    """

    def __init__(
        self,
        params: Iterable,
        lr: LR = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        force_adaptive_momentum: bool = False,
        scale_clip: Optional[Tuple[float, float]] = None,
    ) -> None:
        if not callable(lr) and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        defaults = {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay,
                    "force_adaptive_momentum": force_adaptive_momentum,
                    "scale_clip": scale_clip if scale_clip is not None else (0.0, 10.0), "count": 0}
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
                self.state[p].update({k: torch.zeros_like(p) for k in ("exp_avg", "exp_avg_sq")})
        m, v = ([self.state[p][k] for p in params] for k in ("exp_avg", "exp_avg_sq"))
        grads = [p.grad for p in params]
        lr_t = lr_at(group["lr"], group["count"])
        beta1, beta2 = group["betas"]
        count = group["count"] + 1
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
        bc1, bc2 = bias_correction(beta1, count), bias_correction(beta2, count)
        # the variance rectification (ralars.py:42-47), in float32 as there: sma_t is a
        # difference of two numbers near 2 / (1 - beta2), which double would not round alike
        f32 = np.float32
        sma_inf = 2.0 / (1 - beta2) - 1.0
        sma_t = f32(sma_inf) - f32(2.0) * f32(count) * (f32(1) - f32(bc2)) / f32(bc2)
        update = torch._foreach_div(m, bc1)
        if sma_t > 4 or group["force_adaptive_momentum"]:
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(update, denom)
            if sma_t > 4:
                r_num = max((sma_t - f32(4)) * (sma_t - f32(2)) * f32(sma_inf), f32(0))
                r_den = f32((sma_inf - 4) * (sma_inf - 2)) * max(sma_t, f32(1e-12))
                torch._foreach_mul_(update, float(np.sqrt(r_num / r_den)))
        if group["weight_decay"] != 0:
            torch._foreach_add_(update, params, alpha=group["weight_decay"])
        clip_lo, clip_hi = group["scale_clip"]
        phi_p = torch.stack(torch._foreach_norm(params)).clamp(clip_lo, clip_hi)
        scale = (-lr_t * safe_local_lr(phi_p, torch.stack(torch._foreach_norm(update)))).unbind()
        torch._foreach_add_(params, torch._foreach_mul(update, scale))
