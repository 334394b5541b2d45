"""TridentNet (`Li et al. <https://arxiv.org/pdf/1901.01892.pdf>`_), the port of
``holocron_tpu/models/classification/tridentnet.py``: the container repeats the stem's
channels three times, and each :class:`Tridentneck` runs three branches that share one
kernel a conv (:class:`TridentConv2d`), normalized together over three times the
width."""

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..checkpoints import Checkpoint
from ..layers import BatchNorm2d
from ..presets import IMAGENETTE
from ..utils import conv_sequence
from .resnet import NormLayer, ResNet, _ResBlock, _relu, _resnet

__all__ = ["TridentConv2d", "Tridentneck", "tridentnet50"]

# tridentnet.py:23-29, the input shape channel-first
default_cfgs: Dict[str, Dict[str, Any]] = {
    "tridentnet50": {
        **IMAGENETTE.__dict__,
        "input_shape": (3, 224, 224),
        "url": "https://github.com/frgfm/Holocron/releases/download/v0.1.2/tridentnet50_224-98b4ce9c.pth",
    },
}


class TridentConv2d(nn.Module):
    """One kernel applied to ``num_branches`` channel chunks of the input, their outputs
    concatenated (``tridentnet.py:32-83``). ``in_channels`` counts all branches; the
    kernel is ``(out_channels, in_channels / num_branches / groups, k, k)``. With
    ``dilation`` 1 every branch has dilation 1; with ``dilation == num_branches``,
    branch ``i`` has dilation ``i + 1`` and padding ``(i + 1) * padding``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]] = 1,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = False,
        num_branches: int = 3,
    ) -> None:
        super().__init__()
        if dilation != 1 and dilation != num_branches:
            raise ValueError(f"expected dilation to either be 1 or {num_branches}.")
        if in_channels % num_branches != 0:
            raise ValueError("expected number of channels of input tensor to be a multiple of `num_branches`.")
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.num_branches = num_branches
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // num_branches // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # torch's conv default, until the model's init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.num_branches, dim=1)
        outs = []
        for idx, chunk in enumerate(chunks):
            dilation = 1 if self.dilation == 1 else idx + 1
            outs.append(F.conv2d(chunk, self.weight, self.bias, self.stride, dilation * self.padding, dilation,
                                 self.groups))
        return torch.cat(outs, dim=1)


class Tridentneck(_ResBlock):
    """Bottleneck over three weight-shared branches (``tridentnet.py:86-143``): 1x1,
    3x3 of dilations 1..3, 1x1, each a :class:`TridentConv2d` whose norm spans the
    three branches; it returns ``3 * planes * 4`` channels."""

    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: bool = False,
        groups: int = 1,
        base_width: int = 64,
        dilation: int = 3,
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
        common = {"drop_layer": drop_layer, "conv_layer": TridentConv2d}
        layers = [
            *conv_sequence(inplanes, width, act_layer, norm_layer, kernel_size=1, bn_channels=3 * width, **common),
            *conv_sequence(3 * width, width, act_layer, norm_layer, kernel_size=3, stride=stride, padding=1,
                           groups=groups, dilation=3, bn_channels=3 * width, **common),
            *conv_sequence(3 * width, out_channels, None, norm_layer, kernel_size=1, bn_channels=3 * out_channels,
                           **common),
        ]
        super().__init__(layers, inplanes, 3 * out_channels, stride, downsample, avg_downsample, act_layer,
                         norm_layer)


def tridentnet50(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
                 **kwargs: Any) -> ResNet:
    """TridentNet-50 (``tridentnet.py:154-156``)."""
    return _resnet(Tridentneck, [3, 4, 6, 3], [64, 128, 256, 512], pretrained, checkpoint, progress,
                   default_cfgs["tridentnet50"], num_repeats=3, **kwargs)
