"""Pooling and downsampling modules (``holocron_tpu/nn/modules/downsample.py``), on
NCHW tensors."""

from math import comb
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .. import functional as HF

__all__ = ["SPP", "BlurPool2d", "ConcatDownsample2d", "GlobalAvgPool2d", "GlobalMaxPool2d", "ZPool"]


class ConcatDownsample2d(nn.Module):
    """Loss-less space-to-depth (`YOLO9000 <https://pjreddie.com/media/files/papers/YOLO9000.pdf>`_,
    ``downsample.py:26-38``): ``(N, C, H, W) -> (N, s*s*C, H/s, W/s)``, the channels in
    :func:`~holocron_tpu_torch.nn.functional.concat_downsample2d`'s ``(sh, sw, c)``
    order."""

    def __init__(self, scale_factor: int) -> None:
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return HF.concat_downsample2d(x.permute(0, 2, 3, 1), self.scale_factor).permute(0, 3, 1, 2)


class GlobalAvgPool2d(nn.Module):
    """Global average pooling (``downsample.py:41-55``): ``(N, C, H, W) -> (N, C)`` when
    ``flatten`` else ``(N, C, 1, 1)``."""

    def __init__(self, flatten: bool = False) -> None:
        super().__init__()
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=not self.flatten)


class GlobalMaxPool2d(nn.Module):
    """Global max pooling (``downsample.py:56-67``): ``(N, C, H, W) -> (N, C)`` when
    ``flatten`` else ``(N, C, 1, 1)``."""

    def __init__(self, flatten: bool = False) -> None:
        super().__init__()
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=(2, 3), keepdim=not self.flatten)


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


class SPP(nn.Module):
    """Spatial pyramid pooling (`He et al. <https://arxiv.org/pdf/1406.4729.pdf>`_,
    ``downsample.py:105-147``): ``x`` and its stride-1 max pools of each odd kernel size
    (padding ``k // 2``, which never wins the max), concatenated along channels.

    Each level is pooled from ``x`` with its full window. The JAX package pools each
    level from the previous one with the window of the difference (its backward is
    cheaper on the TPU); by ``mp_b(mp_a(x)) == mp_{a+b-1}(x)`` the values are the same,
    and only the subgradient at exact ties may be routed elsewhere.
    """

    def __init__(self, kernel_sizes: Sequence[int]) -> None:
        super().__init__()
        self.kernel_sizes = list(kernel_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, *(F.max_pool2d(x, k, 1, k // 2) for k in self.kernel_sizes)], dim=1)


class ZPool(nn.Module):
    """Z-pool (`"Rotate to Attend" <https://arxiv.org/pdf/2010.03045.pdf>`_,
    ``downsample.py:150-162``): the max and the mean along ``dim`` (by default the
    channels of an NCHW tensor, the JAX package's last axis of an NHWC one),
    concatenated there."""

    def __init__(self, dim: int = 1) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return HF.z_pool(x, self.dim)
