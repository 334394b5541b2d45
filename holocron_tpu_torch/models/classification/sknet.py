"""SKNet (`Li et al. <https://arxiv.org/pdf/1903.06586.pdf>`_), the port of
``holocron_tpu/models/classification/sknet.py``: bottlenecks whose middle conv is a
selective-kernel :class:`SKConv2d`, in the :class:`~.resnet.ResNet` container."""

from enum import Enum
from typing import Any, Callable, Optional

import torch
from torch import nn

from ...nn.modules.downsample import GlobalAvgPool2d
from ..layers import BatchNorm2d
from ..utils import conv_sequence
from .resnet import NormLayer, ResNet, _ResBlock, _release, _relu, _resnet

__all__ = ["SKBottleneck", "SKConv2d", "SKNet50_Checkpoint", "SoftAttentionLayer", "sknet50", "sknet101", "sknet152"]


class SoftAttentionLayer(nn.Sequential):
    """Global average pool, a 1x1 squeeze conv + norm + act to ``max(C // sa_ratio,
    32)`` channels, a biased 1x1 excite conv to ``C * out_multiplier`` channels and a
    sigmoid (``sknet.py:23-56``); keys ``1`` (squeeze), ``2`` (its norm) and ``4``
    (excite), as original Holocron."""

    def __init__(
        self,
        channels: int,
        sa_ratio: int = 16,
        out_multiplier: int = 1,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
    ) -> None:
        mid = max(channels // sa_ratio, 32)
        super().__init__(
            GlobalAvgPool2d(flatten=False),
            *conv_sequence(channels, mid, act_layer or _relu(), norm_layer or BatchNorm2d, drop_layer, kernel_size=1),
            *conv_sequence(mid, channels * out_multiplier, nn.Sigmoid(), None, drop_layer, kernel_size=1),
        )


class SKConv2d(nn.Module):
    """Selective-kernel conv (``sknet.py:59-101``): ``m`` 3x3 conv + norm + act paths of
    dilation 1..m (keys ``path_convs.{k}``), whose sum feeds a
    :class:`SoftAttentionLayer` (key ``sa``); its ``m * C`` outputs, read channel-major
    as ``(m, C)``, are softmaxed over the paths and weight their sum."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        m: int = 2,
        sa_ratio: int = 16,
        groups: int = 1,
        stride: int = 1,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
    ) -> None:
        super().__init__()
        act_layer, norm_layer = act_layer or _relu(), norm_layer or BatchNorm2d
        self.m, self.out_channels = m, out_channels
        self.path_convs = nn.ModuleList(
            nn.Sequential(*conv_sequence(in_channels, out_channels, act_layer, norm_layer, drop_layer, kernel_size=3,
                                         dilation=idx + 1, padding=idx + 1, stride=stride, groups=groups))
            for idx in range(m)
        )
        self.sa = SoftAttentionLayer(out_channels, sa_ratio, m, act_layer, norm_layer, drop_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        paths = torch.stack([conv(x) for conv in self.path_convs], dim=1)  # (N, m, C, H, W)
        z = self.sa(paths.sum(dim=1)).reshape(x.shape[0], self.m, self.out_channels, 1, 1)
        return (torch.softmax(z, dim=1) * paths).sum(dim=1)


class SKBottleneck(_ResBlock):
    """SKNet bottleneck (``sknet.py:104-158``): 1x1, :class:`SKConv2d` (key ``conv.3``),
    1x1. Its own ``groups`` default is 32, but the container passes ``groups=1``
    unless told otherwise, as the JAX package does."""

    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: bool = False,
        groups: int = 32,
        base_width: int = 64,
        dilation: int = 1,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        avg_downsample: bool = False,
        zero_init_residual: bool = False,
    ) -> None:
        act_layer = act_layer or _relu()
        norm_layer = norm_layer or BatchNorm2d
        width = int(planes * (base_width / 64.0)) * groups
        out_channels = planes * self.expansion
        layers = [
            *conv_sequence(inplanes, width, act_layer, norm_layer, drop_layer, kernel_size=1),
            SKConv2d(width, width, 2, 16, groups, stride, act_layer, norm_layer, drop_layer),
            *conv_sequence(width, out_channels, None, norm_layer, drop_layer, kernel_size=1),
        ]
        super().__init__(layers, inplanes, out_channels, stride, downsample, avg_downsample, act_layer, norm_layer)


class SKNet50_Checkpoint(Enum):
    IMAGENETTE = _release("sknet50", "sknet50_224-e2349031.pth", 0.9437, 0.9954,
                          "e2349031c838a4661cd729dbc7825605c9e0c966bd89bbcc9b39f0e324894d1f", 141253623, 35224394)
    DEFAULT = IMAGENETTE


def sknet50(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """SKNet-50 (``sknet.py:185-188``)."""
    return _resnet(SKBottleneck, [3, 4, 6, 3], [64, 128, 256, 512], pretrained, **kwargs)


def sknet101(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """SKNet-101 (``sknet.py:191-193``)."""
    return _resnet(SKBottleneck, [3, 4, 23, 3], [64, 128, 256, 512], pretrained, **kwargs)


def sknet152(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """SKNet-152 (``sknet.py:196-198``)."""
    return _resnet(SKBottleneck, [3, 8, 86, 3], [64, 128, 256, 512], pretrained, **kwargs)
