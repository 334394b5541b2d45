"""Lookahead and Scout, the port of ``holocron_tpu/optim/wrapper.py``: wrappers that keep
slow weights beside a base optimizer's fast ones and, every ``sync_period`` steps, move
the slow weights toward the fast ones, ``slow += rate * (fast - slow)``, and restart the
fast weights from them."""

from typing import List

import torch

__all__ = ["Lookahead", "Scout"]


def _check_args(sync_rate: float, sync_period: int) -> None:
    if sync_rate < 0 or sync_rate > 1:
        raise ValueError(f"expected positive float lower than 1 as sync_rate, received: {sync_rate}")
    if not isinstance(sync_period, int) or sync_period < 1:
        raise ValueError(f"expected positive integer as sync_period, received: {sync_period}")


class Lookahead:
    """Lookahead (`Zhang et al. <https://arxiv.org/pdf/1907.08610.pdf>`_,
    ``wrapper.py:34-72``) around a built optimizer, e.g. ``Lookahead(AdamP(params, lr))``.

    ``step()`` runs the base optimizer's step, then syncs at every ``sync_period``-th
    call, over every parameter of the base optimizer's groups; the count of steps and
    the choice to sync stay on the host, so ``step()`` reads nothing from the device.
    ``param_groups`` are the base optimizer's.

    Args:
        base_optimizer: the optimizer of the fast weights
        sync_rate: the rate above
        sync_period: steps between two syncs
    """

    def __init__(self, base_optimizer: torch.optim.Optimizer, sync_rate: float = 0.5, sync_period: int = 6) -> None:
        _check_args(sync_rate, sync_period)
        self.base_optimizer = base_optimizer
        self.sync_rate, self.sync_period = sync_rate, sync_period
        self.count = 0
        self.params: List[torch.Tensor] = [p for group in base_optimizer.param_groups for p in group["params"]]
        self.slow_params = [p.detach().clone() for p in self.params]

    @property
    def param_groups(self) -> list:
        return self.base_optimizer.param_groups

    @torch.no_grad()
    def step(self, closure=None):
        loss = self.base_optimizer.step(closure)
        self.count += 1
        if self.count % self.sync_period == 0:
            self._sync(self.sync_rate)
        return loss

    def _sync(self, rate) -> None:
        """``slow += rate * (fast - slow)``, then the fast weights take the slow ones;
        ``rate`` a number or a 0-d tensor on the device."""
        diff = torch._foreach_sub(self.params, self.slow_params)
        torch._foreach_mul_(diff, rate)
        torch._foreach_add_(self.slow_params, diff)
        torch._foreach_copy_(self.params, self.slow_params)


class Scout(Lookahead):
    """Scout (``wrapper.py:75-127``, experimental): Lookahead whose sync rate is
    ``max(1 - coherence, sync_rate)``, the coherence of the fast weights' steps over the
    period: for each parameter, the mean over its elements of ``std / max|d - mean(d)|``
    of its successive steps ``d`` (0 where that maximum is 0), then the mean over the
    parameters, reduced on the device.

    The fast weights after each step are kept in a buffer of ``sync_period + 1`` copies
    of every parameter (slot 0 the weights the period started from); at a sync the
    buffer restarts from the synced weights.
    """

    def __init__(self, base_optimizer: torch.optim.Optimizer, sync_rate: float = 0.5, sync_period: int = 6) -> None:
        super().__init__(base_optimizer, sync_rate, sync_period)
        self.buffers = [p.detach().unsqueeze(0).repeat(sync_period + 1, *(1,) * p.ndim) for p in self.params]

    @torch.no_grad()
    def step(self, closure=None):
        loss = self.base_optimizer.step(closure)
        self.count += 1
        slot = (self.count - 1) % self.sync_period + 1
        for buf, p in zip(self.buffers, self.params):
            buf[slot].copy_(p)
        if self.count % self.sync_period == 0:
            self._sync(torch.clamp_min(1.0 - self.coherence(), self.sync_rate))
            for buf, p in zip(self.buffers, self.params):
                buf.copy_(p.unsqueeze(0).expand_as(buf))
        return loss

    def coherence(self) -> torch.Tensor:
        """The coherence of the buffered steps, a 0-d float32 tensor on the device
        (``wrapper.py:104-114``)."""
        sims = []
        for buf in self.buffers:
            diffs = buf[1:] - buf[:-1]
            std = diffs.std(dim=0, correction=1)
            max_dev = (diffs - diffs.mean(dim=0)).abs().amax(dim=0)
            live = max_dev > 0
            sims.append(torch.where(live, std / torch.where(live, max_dev, torch.ones_like(max_dev)),
                                    torch.zeros_like(std)).mean())
        return torch.stack(sims).mean()
