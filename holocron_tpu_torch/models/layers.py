"""Shared low-level layers (``holocron_tpu/models/layers.py``).

``BatchNorm2d``: the JAX package's batch norm was written to reproduce
``torch.nn.BatchNorm2d`` (momentum 0.1 in torch's convention, eps 1e-5, biased batch
variance for normalizing and unbiased variance for the running estimate, float32
statistics), so the port uses torch's module as it is. The JAX form computes the
batch variance in one shifted pass (``layers.py:82-93``) where torch takes two; the
two differ by rounding only.
"""

from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["BatchNorm2d", "act_fn"]

BatchNorm2d = nn.BatchNorm2d

_ACTIVATIONS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "silu": F.silu,
    "swish": F.silu,
    "mish": F.mish,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "hard_mish": lambda x: 0.5 * x * torch.clamp(x + 2.0, 0.0, 2.0),
    "nl_relu": lambda x: torch.log1p(F.relu(x)),
    "sigmoid": torch.sigmoid,
}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolves an activation function by name (``layers.py:142``)."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation: {name}")
    return _ACTIVATIONS[name]
