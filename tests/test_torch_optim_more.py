"""The port's LARS, RaLars, Adan, AdEMAMix, Lookahead and Scout against the JAX
package's optax transforms, on the CPU: the same initial parameters and gradients,
made from a numpy seed, five steps (seven for the wrappers, across a sync), the
parameters held after each step."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from holocron_tpu import optim as jax_optim
from holocron_tpu_torch import optim

torch.set_num_threads(2)

SHAPES = {"w": (4, 3), "b": (3,), "z": (5,)}  # "z" starts at 0: the trust ratio's fallback to 1
RTOL = 1e-6


def _halving(count):
    return 1e-2 * 0.5**count


def _trajectory(jax_tx, torch_opt_fn, steps: int = 5, sparse_grad: bool = False):
    """Runs both for ``steps`` steps; returns the largest relative difference seen."""
    rng = np.random.default_rng(0)
    init = {k: (np.zeros(s) if k == "z" else rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = jax_tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = torch_opt_fn(list(tparams.values()))
    for g in grads:
        updates, state = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=RTOL, atol=RTOL)
    return opt, state


CASES = {
    "lars-plain": (lambda: jax_optim.lars(1e-2), lambda p: optim.LARS(p, 1e-2)),
    "lars-momentum-decay": (lambda: jax_optim.lars(_halving, momentum=0.9, weight_decay=1e-2),
                            lambda p: optim.LARS(p, _halving, momentum=0.9, weight_decay=1e-2)),
    "lars-dampening": (lambda: jax_optim.lars(1e-2, momentum=0.9, dampening=0.3),
                       lambda p: optim.LARS(p, 1e-2, momentum=0.9, dampening=0.3)),
    "lars-nesterov": (lambda: jax_optim.lars(1e-2, momentum=0.9, weight_decay=1e-2, nesterov=True),
                      lambda p: optim.LARS(p, 1e-2, momentum=0.9, weight_decay=1e-2, nesterov=True)),
    "ralars": (lambda: jax_optim.ralars(1e-2), lambda p: optim.RaLars(p, 1e-2)),
    "ralars-decay-clip-schedule": (lambda: jax_optim.ralars(_halving, weight_decay=1e-2, scale_clip=(0.5, 2.0)),
                                   lambda p: optim.RaLars(p, _halving, weight_decay=1e-2, scale_clip=(0.5, 2.0))),
    "ralars-forced": (lambda: jax_optim.ralars(1e-2, force_adaptive_momentum=True),
                      lambda p: optim.RaLars(p, 1e-2, force_adaptive_momentum=True)),
    "adan": (lambda: jax_optim.adan(1e-2), lambda p: optim.Adan(p, 1e-2)),
    "adan-decay-schedule": (lambda: jax_optim.adan(_halving, weight_decay=2e-2),
                            lambda p: optim.Adan(p, _halving, weight_decay=2e-2)),
    "adan-amsgrad-decay": (lambda: jax_optim.adan(1e-2, weight_decay=2e-2, amsgrad=True),
                           lambda p: optim.Adan(p, 1e-2, weight_decay=2e-2, amsgrad=True)),
    "ademamix": (lambda: jax_optim.ademamix(1e-2), lambda p: optim.AdEMAMix(p, 1e-2)),
    "ademamix-decay-schedule": (lambda: jax_optim.ademamix(_halving, weight_decay=2e-2, alpha=3.0),
                                lambda p: optim.AdEMAMix(p, _halving, weight_decay=2e-2, alpha=3.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_matches_optax_trajectory(name):
    jax_tx, torch_opt = CASES[name]
    opt, state = _trajectory(jax_tx(), torch_opt)
    assert opt.param_groups[0]["count"] == int(state.count) == 5


@pytest.mark.parametrize("wrapper", ["Lookahead", "Scout"])
@pytest.mark.parametrize("sync_period", [3, 1])
def test_wrappers_match_optax_across_a_sync(wrapper, sync_period):
    """Seven steps of AdamP under the wrapper: two syncs at period 3, one every step at
    period 1 (Scout's buffer restarting from the synced weights each time)."""
    jax_wrap = getattr(jax_optim, wrapper.lower())
    ours = getattr(optim, wrapper)
    opt, state = _trajectory(
        jax_wrap(jax_optim.adamp(1e-2, weight_decay=1e-2), sync_rate=0.4, sync_period=sync_period),
        lambda p: ours(optim.AdamP(p, 1e-2, weight_decay=1e-2), sync_rate=0.4, sync_period=sync_period), steps=7)
    assert opt.count == int(state.count) == 7
    assert opt.param_groups[0]["count"] == 7
    if wrapper == "Scout":
        assert all(b.shape[0] == sync_period + 1 for b in opt.buffers)


def test_scout_coherence_matches_jax():
    """The coherence statistic on a buffer of drawn steps, against the JAX
    expression (``wrapper.py:104-114``), one parameter with a constant element."""
    rng = np.random.default_rng(1)
    bufs = [rng.normal(size=(4, 3, 2)).astype(np.float32), rng.normal(size=(4, 5)).astype(np.float32)]
    bufs[1][:, 0] = 1.0  # no step: its max deviation is 0
    opt = optim.Scout(optim.AdamP([torch.nn.Parameter(torch.zeros(3, 2)), torch.nn.Parameter(torch.zeros(5))]),
                      sync_period=3)
    opt.buffers = [torch.from_numpy(b) for b in bufs]

    def leaf(b):
        diffs = b[1:] - b[:-1]
        std = jnp.std(diffs, axis=0, ddof=1)
        max_dev = jnp.max(jnp.abs(diffs - jnp.mean(diffs, axis=0)), axis=0)
        return jnp.mean(jnp.where(max_dev > 0, std / jnp.where(max_dev > 0, max_dev, 1.0), 0.0))

    expected = sum(leaf(jnp.asarray(b)) for b in bufs) / len(bufs)
    np.testing.assert_allclose(float(opt.coherence()), float(expected), rtol=1e-6)


def test_new_optimizers_reject_bad_arguments():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="Nesterov"):
        optim.LARS(p, momentum=0.0, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        optim.LARS(p, momentum=0.9, dampening=0.1, nesterov=True)
    for cls in (optim.LARS, optim.RaLars, optim.Adan, optim.AdEMAMix):
        with pytest.raises(ValueError):
            cls(p, lr=-1.0)
    for cls in (optim.Lookahead, optim.Scout):
        with pytest.raises(ValueError):
            cls(optim.AdamP(p), sync_rate=1.5)
        with pytest.raises(ValueError):
            cls(optim.AdamP(p), sync_period=0)


@pytest.mark.parametrize("name", ["LARS", "RaLars", "Adan", "AdEMAMix"])
def test_a_parameter_without_gradient_is_left_alone(name):
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    opt = getattr(optim, name)([a, b], 1e-2)
    a.grad = torch.ones(3)
    opt.step()
    assert torch.equal(b, torch.ones(2)) and not torch.equal(a, torch.ones(3))
    assert opt.param_groups[0]["count"] == 1
