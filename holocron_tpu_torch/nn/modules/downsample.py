"""Pooling and downsampling modules (``holocron_tpu/nn/modules/downsample.py``)."""

from math import comb

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["BlurPool2d", "GlobalAvgPool2d"]


class GlobalAvgPool2d(nn.Module):
    """Global average pooling (``downsample.py:41-55``): ``(N, C, H, W) -> (N, C)`` when
    ``flatten`` else ``(N, C, 1, 1)``."""

    def __init__(self, flatten: bool = False) -> None:
        super().__init__()
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=not self.flatten)


class BlurPool2d(nn.Module):
    """Anti-aliased downsampling (`Zhang <https://arxiv.org/pdf/1904.11486.pdf>`_,
    ``downsample.py:70-103``): a reflect pad of ``((stride - 1) + (k - 1)) // 2``, then
    a fixed binomial depthwise ``k x k`` filter with ``stride``.

    The filter is a non-persistent buffer: it follows the module's device and dtype
    and has no ``state_dict`` entry, as the JAX module has no variable.
    """

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 2) -> None:
        super().__init__()
        if kernel_size <= 1:
            raise AssertionError
        self.channels, self.kernel_size, self.stride = channels, kernel_size, stride
        # binomial coefficients of (0.5 + 0.5 z)^(k - 1)
        coeffs = torch.tensor([comb(kernel_size - 1, i) / 2 ** (kernel_size - 1) for i in range(kernel_size)])
        filt = (coeffs[:, None] * coeffs[None, :]).expand(channels, 1, kernel_size, kernel_size)
        self.register_buffer("filt", filt.contiguous(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = ((self.stride - 1) + (self.kernel_size - 1)) // 2
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
        return F.conv2d(x, self.filt.to(x.dtype), stride=self.stride, groups=self.channels)
