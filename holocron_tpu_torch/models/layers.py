"""Shared low-level layers (``holocron_tpu/models/layers.py``), on NCHW tensors.

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

from ..nn.functional import hard_mish, nl_relu

__all__ = ["AvgPool2d", "BatchNorm2d", "FrozenBatchNorm2d", "act_fn", "avg_pool2d", "max_pool2d"]

BatchNorm2d = nn.BatchNorm2d


def max_pool2d(x: torch.Tensor, kernel_size: int, stride: int, padding: int = 0) -> torch.Tensor:
    """torch-style max pool (``layers.py:16-26``): padding never wins the max."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def avg_pool2d(
    x: torch.Tensor,
    kernel_size: int,
    stride: int,
    padding: int = 0,
    ceil_mode: bool = False,
    count_include_pad: bool = True,
) -> torch.Tensor:
    """Average pool with the JAX package's semantics (``layers.py:29-56``): with
    ``ceil_mode`` the output has ``ceil((size + 2 padding - k) / stride) + 1`` rows
    (no rule dropping a last window that starts in the padding), the input is
    zero-padded on the high side up to the window grid, and each window's sum is
    divided by ``k * k`` when ``count_include_pad`` and not ``ceil_mode``, else by the
    number of input elements it covers (so padding never counts, ResNet-D's shortcut)."""
    h, w = x.shape[-2:]

    def out_size(size: int) -> int:
        eff = size + 2 * padding - kernel_size
        return -(-eff // stride) + 1 if ceil_mode else eff // stride + 1

    oh, ow = out_size(h), out_size(w)
    pad_h_hi = max(0, (oh - 1) * stride + kernel_size - h - padding)
    pad_w_hi = max(0, (ow - 1) * stride + kernel_size - w - padding)
    pads = (padding, pad_w_hi, padding, pad_h_hi)
    summed = F.avg_pool2d(F.pad(x, pads), kernel_size, stride, divisor_override=1)
    if count_include_pad and not ceil_mode:
        return summed / (kernel_size * kernel_size)
    ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device), pads)
    return summed / F.avg_pool2d(ones, kernel_size, stride, divisor_override=1)


class AvgPool2d(nn.Module):
    """:func:`avg_pool2d` as a module (the pool of ResNet-D's shortcut)."""

    def __init__(self, kernel_size: int, stride: int, padding: int = 0, ceil_mode: bool = False,
                 count_include_pad: bool = True) -> None:
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.ceil_mode, self.count_include_pad = ceil_mode, count_include_pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool2d(x, self.kernel_size, self.stride, self.padding, self.ceil_mode, self.count_include_pad)


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with frozen statistics and affine parameters (``layers.py:107-126``):
    ``weight``, ``bias``, ``running_mean`` and ``running_var`` are buffers, never
    parameters, so no optimizer touches them; computed in float32 in the JAX package's
    order, ``(x - mean) * rsqrt(var + eps) * weight + bias``, returned in x's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def per_channel(t: torch.Tensor) -> torch.Tensor:
            return t.float().reshape(1, -1, 1, 1)

        y = (x.float() - per_channel(self.running_mean)) * torch.rsqrt(per_channel(self.running_var) + self.eps)
        return (y * per_channel(self.weight) + per_channel(self.bias)).to(x.dtype)

_ACTIVATIONS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "silu": F.silu,
    "swish": F.silu,
    "mish": F.mish,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "hard_mish": hard_mish,
    "nl_relu": nl_relu,
    "sigmoid": torch.sigmoid,
}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolves an activation function by name (``layers.py:142``)."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation: {name}")
    return _ACTIVATIONS[name]
