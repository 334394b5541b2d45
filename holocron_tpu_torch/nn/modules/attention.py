"""Attention modules (``holocron_tpu/nn/modules/attention.py``), on NCHW tensors.

Weights are drawn from the caller's ``generator`` on the CPU (fan-out He-normal convs,
zero biases), then each module moves to ``device``: the card unless the caller asks
for the CPU. Submodules keep the JAX modules' names, which
:func:`~holocron_tpu_torch.convert.nn_state_dict` reads.
"""

from typing import Optional, Union

import torch
from torch import nn

from .. import functional as HF
from ..init import kaiming_normal_
from ._norm import FlaxBatchNorm2d

__all__ = ["SAM", "DimAttention", "TripletAttention"]

Device = Union[str, torch.device]


def _conv(in_channels: int, out_channels: int, kernel_size: int, generator: Optional[torch.Generator], **kwargs):
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, **kwargs)
    kaiming_normal_(conv.weight, generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


class SAM(nn.Module):
    """Spatial attention of CBAM (`Woo et al. <https://arxiv.org/pdf/1807.06521.pdf>`_)
    as YOLOv4 modifies it (``attention.py:16-26``): ``x * sigmoid(conv1x1(x))``, the
    biased 1x1 conv to one channel."""

    def __init__(self, in_channels: int, device: Device = torch.device("cuda"),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.conv = _conv(in_channels, 1, 1, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(x))


class DimAttention(nn.Module):
    """An attention gate across one axis (``attention.py:29-50``): Z-pool over ``dim``,
    a 7x7 conv from 2 channels to 1 over the other two axes, BN and a sigmoid.

    ``dim`` is an NCHW axis: 1 the channels, 2 the height, 3 the width (the JAX
    module's NHWC ``axis`` 3, 1 and 2). As the JAX module, the attended axis is swapped
    into the channels' place of the NHWC view, so the conv's kernel rows run along the
    same axis in both packages. The norm is flax's (:class:`FlaxBatchNorm2d`),
    momentum 0.01 in torch's convention (the JAX package's 0.99).
    """

    _NHWC_AXIS = {1: 3, 2: 1, 3: 2}

    def __init__(self, dim: int = 1, device: Device = torch.device("cuda"),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if dim not in self._NHWC_AXIS:
            raise ValueError(f"dim must be 1, 2 or 3 (an NCHW axis), got {dim}")
        self.dim = dim
        self.conv = _conv(2, 1, 7, generator, padding=3, bias=False)
        self.bn = FlaxBatchNorm2d(1, momentum=0.01)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self._NHWC_AXIS[self.dim]
        xh = x.permute(0, 2, 3, 1)
        if axis != 3:
            xh = xh.transpose(axis, 3)
        pooled = HF.z_pool(xh, -1).permute(0, 3, 1, 2)  # (N, 2, A, B)
        gate = torch.sigmoid(self.bn(self.conv(pooled))).permute(0, 2, 3, 1)
        out = xh * gate
        if axis != 3:
            out = out.transpose(axis, 3)
        return out.permute(0, 3, 1, 2)


class TripletAttention(nn.Module):
    """Triplet attention (`Misra et al. <https://arxiv.org/pdf/2010.03045.pdf>`_,
    ``attention.py:53-65``): the mean of :class:`DimAttention` over the channels, the
    height and the width."""

    def __init__(self, device: Device = torch.device("cuda"), generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.c_branch = DimAttention(1, device, generator)
        self.h_branch = DimAttention(2, device, generator)
        self.w_branch = DimAttention(3, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.c_branch(x) + self.h_branch(x) + self.w_branch(x)) / 3.0
