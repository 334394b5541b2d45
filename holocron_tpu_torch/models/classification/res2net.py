"""Res2Net (`Gao et al. <https://arxiv.org/pdf/1904.01169.pdf>`_), the port of
``holocron_tpu/models/classification/res2net.py``: bottlenecks whose middle conv is a
:class:`ScaleConv2d`, in the :class:`~.resnet.ResNet` container."""

from enum import Enum
from math import floor
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..layers import BatchNorm2d, avg_pool2d
from ..utils import conv_sequence
from .resnet import NormLayer, ResNet, _ResBlock, _release, _relu, _resnet

__all__ = ["Bottle2neck", "Res2Net50_26w_4s_Checkpoint", "ScaleConv2d", "res2net50_26w_4s"]


class ScaleConv2d(nn.Module):
    """Multi-scale conv (``res2net.py:24-65``): the channels split into ``scale`` groups
    of ``planes // scale``; the first ``scale - 1`` go through 3x3 conv + norm + act
    (keys ``conv.{k}.{0,1}``), each but the first after adding the previous one's output
    (no cascade when ``downsample``); the last split is kept as it is, or average-pooled
    (3x3, ``stride``, padding 1, padding counted) when ``downsample``."""

    def __init__(
        self,
        scale: int,
        planes: int,
        stride: int = 1,
        groups: int = 1,
        downsample: bool = False,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
    ) -> None:
        super().__init__()
        self.scale, self.width, self.stride, self.downsample = scale, planes // scale, stride, downsample
        self.conv = nn.ModuleList(
            nn.Sequential(*conv_sequence(self.width, self.width, act_layer or _relu(), norm_layer or BatchNorm2d,
                                         drop_layer, kernel_size=3, stride=stride, padding=1, groups=groups))
            for _ in range(max(1, scale - 1))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        splits = torch.split(x, self.width, dim=1)
        outs = []
        for idx, conv in enumerate(self.conv):
            outs.append(conv(splits[idx] if idx == 0 or self.downsample else outs[-1] + splits[idx]))
        if self.scale > 1:
            last = splits[self.scale - 1]
            outs.append(avg_pool2d(last, 3, self.stride, padding=1) if self.downsample else last)
        return torch.cat(outs, dim=1)


class Bottle2neck(_ResBlock):
    """Res2Net bottleneck (``res2net.py:68-125``): 1x1 widen to ``floor(planes *
    base_width / 64) * groups * scale`` channels, :class:`ScaleConv2d` (key
    ``conv.3``; it pools its last split whenever the block strides or projects), 1x1
    project."""

    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: bool = False,
        groups: int = 1,
        base_width: int = 26,
        dilation: int = 1,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        avg_downsample: bool = False,
        zero_init_residual: bool = False,
        scale: int = 4,
    ) -> None:
        act_layer = act_layer or _relu()
        norm_layer = norm_layer or BatchNorm2d
        width = floor(planes * (base_width / 64.0)) * groups
        out_channels = planes * self.expansion
        layers = [
            *conv_sequence(inplanes, width * scale, act_layer, norm_layer, drop_layer, kernel_size=1),
            ScaleConv2d(scale, width * scale, stride, groups, stride > 1 or downsample, act_layer, norm_layer,
                        drop_layer),
            *conv_sequence(width * scale, out_channels, None, norm_layer, drop_layer, kernel_size=1),
        ]
        super().__init__(layers, inplanes, out_channels, stride, downsample, avg_downsample, act_layer, norm_layer)


class Res2Net50_26w_4s_Checkpoint(Enum):
    IMAGENETTE = _release("res2net50_26w_4s", "res2net50_26w_4s_224-345170e8.pth", 0.9394, 0.9941,
                          "345170e8ff75d10330af55674090b0d9aa751e14b6f3b4a95bb8ea6cdd65be4b", 95020747, 23670610)
    DEFAULT = IMAGENETTE


def res2net50_26w_4s(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """Res2Net-50 26w x 4s (``res2net.py:162-167``)."""
    return _resnet(Bottle2neck, [3, 4, 6, 3], [64, 128, 256, 512], pretrained, width_per_group=26,
                   block_args={"scale": 4}, **kwargs)
