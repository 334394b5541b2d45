"""The port's classification losses against the JAX package's, on the CPU: the same
numpy inputs, channel-last logits in both, atol 1e-6 plus rtol 1e-6 (a ``sum`` of up to
24 terms near 100 is added in another order by the two frameworks: a few float32 ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu.nn import functional as JF
from holocron_tpu_torch.nn import functional as TF

torch.set_num_threads(2)

K = 5


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, K)).astype(np.float32) * 3
    target = rng.integers(0, K, size=shape).astype(np.int64)
    target.reshape(-1)[::4] = 2  # several targets of the class that ignore_index drops
    weight = rng.uniform(0.5, 2.0, size=K).astype(np.float32)
    return x, target, weight


@pytest.mark.parametrize("shape", [(6,), (2, 3, 4)], ids=["NK", "NHWK"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("ignore_index", [-100, 2])
def test_cross_entropy_matches_jax(shape, reduction, weighted, ignore_index):
    x, target, weight = _inputs(shape)
    w = weight if weighted else None
    expected = JF.cross_entropy(jnp.asarray(x), jnp.asarray(target), None if w is None else jnp.asarray(w),
                                ignore_index, reduction)
    out = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(target), None if w is None else torch.from_numpy(w),
                           ignore_index, reduction)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("ignore_index", [-100, 2])
def test_multilabel_cross_entropy_matches_jax(reduction, weighted, ignore_index):
    """On label-smoothed one-hot targets (smoothing 0.1), as the classification
    reference builds them (references/classification/train.py:246-250)."""
    x, target, weight = _inputs((6,), seed=1)
    smoothed = (np.eye(K, dtype=np.float32)[target] * 0.9 + 0.1 / K).astype(np.float32)
    w = weight if weighted else None
    expected = JF.multilabel_cross_entropy(jnp.asarray(x), jnp.asarray(smoothed),
                                           None if w is None else jnp.asarray(w), ignore_index, reduction)
    out = TF.multilabel_cross_entropy(torch.from_numpy(x), torch.from_numpy(smoothed),
                                      None if w is None else torch.from_numpy(w), ignore_index, reduction)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), rtol=1e-6, atol=1e-6)
