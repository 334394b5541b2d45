"""The port's LAMB and learning-rate schedules against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from holocron_tpu.optim import lamb
from holocron_tpu_torch.optim import LAMB, schedules

torch.set_num_threads(2)

SHAPES = {"w": (4, 3), "b": (3,), "z": (5,)}  # "z" starts at 0: the trust ratio's fallback to 1


def _halving(count):
    return 1e-2 * 0.5**count


@pytest.mark.parametrize(
    "weight_decay,scale_clip,lr",
    [(0.0, None, 1e-2), (1e-2, (0.5, 2.0), _halving), (1e-2, None, _halving)],
    ids=["plain", "decay-clip-schedule", "decay-schedule"],
)
def test_lamb_matches_jax_step_by_step(weight_decay, scale_clip, lr):
    """Five steps on the same gradients: params within atol 1e-6 after each."""
    rng = np.random.default_rng(0)
    init = {k: (np.zeros(s) if k == "z" else rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(5)]

    tx = lamb(lr=lr, weight_decay=weight_decay, scale_clip=scale_clip)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = LAMB(list(tparams.values()), lr=lr, weight_decay=weight_decay, scale_clip=scale_clip)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6)
    assert opt.param_groups[0]["count"] == int(state.count) == 5


def test_lamb_rejects_bad_arguments():
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kwargs in ({"lr": -1.0}, {"eps": -1.0}, {"betas": (1.0, 0.9)}):
        with pytest.raises(ValueError):
            LAMB(p, **kwargs)


@pytest.mark.parametrize("total", [5, 8, 37])
def test_schedules_match_optax(total):
    """onecycle and cosine at every count up to past the end: within rtol 1e-5 of
    optax's value, which is computed in float32 through a cosine and a few products
    (the port computes in double)."""
    counts = range(total + 3)
    pairs = [
        (optax.cosine_onecycle_schedule(total, 1e-3), schedules.cosine_onecycle_schedule(total, 1e-3)),
        (optax.cosine_onecycle_schedule(total, 1e-3, pct_start=0.5), schedules.cosine_onecycle_schedule(total, 1e-3, pct_start=0.5)),
        (optax.cosine_decay_schedule(1e-3, total, alpha=0.1), schedules.cosine_decay_schedule(1e-3, total, alpha=0.1)),
    ]
    for theirs, ours in pairs:
        expected = np.array([float(theirs(np.int32(c))) for c in counts])
        np.testing.assert_allclose([ours(c) for c in counts], expected, rtol=1e-5, atol=1e-12)
    assert schedules.constant_schedule(0.1)(7) == 0.1
