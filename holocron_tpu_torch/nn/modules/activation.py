"""Activation modules (``holocron_tpu/nn/modules/activation.py``), on NCHW tensors."""

from typing import Optional, Union

import torch
from torch import nn

from .. import functional as HF
from ..init import kaiming_normal_
from ._norm import FlaxBatchNorm2d

__all__ = ["FReLU", "HardMish", "NLReLU"]


class HardMish(nn.Module):
    """HardMish (`H-Mish <https://github.com/digantamisra98/H-Mish>`_,
    ``activation.py:16-25``): ``x / 2 * min(2, max(0, x + 2))``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return HF.hard_mish(x)


class NLReLU(nn.Module):
    """Natural-log ReLU (`Liu & Di <https://arxiv.org/pdf/1908.03682.pdf>`_,
    ``activation.py:28-39``): ``ln(1 + beta * max(0, x))``."""

    def __init__(self, beta: float = 1.0) -> None:
        super().__init__()
        self.beta = beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return HF.nl_relu(x, self.beta)


class FReLU(nn.Module):
    """Funnel activation (`Ma et al. <https://arxiv.org/pdf/2007.11824.pdf>`_,
    ``activation.py:42-63``): ``max(x, BN(depthwise_conv(x)))``, the depthwise
    ``kernel_size`` conv biased and padded to keep the size.

    The conv's weight is drawn from ``generator`` on the CPU (fan-out He-normal, zero
    bias), then the module moves to ``device``: the card unless the caller asks for the
    CPU. The norm is flax's (:class:`FlaxBatchNorm2d`), momentum 0.1 in torch's
    convention.
    """

    def __init__(
        self,
        in_channels: int,
        kernel_size: int = 3,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, kernel_size, padding=kernel_size // 2, groups=in_channels)
        kaiming_normal_(self.conv.weight, generator=generator)
        nn.init.zeros_(self.conv.bias)
        self.bn = FlaxBatchNorm2d(in_channels)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(x, self.bn(self.conv(x)))
