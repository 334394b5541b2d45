"""ResNet / ResNeXt / ResNet-D (`He et al. <https://arxiv.org/pdf/1512.03385.pdf>`_,
`Xie et al. <https://arxiv.org/pdf/1611.05431.pdf>`_), the port of
``holocron_tpu/models/classification/resnet.py``.

:class:`ResNet` is the generic container of the family: a stem (7x7, or three 3x3
convs for the deep stem), an optional max pool, an optional channel repeat
(TridentNet), stages of any block class, global average pooling and a linear head.
Res2Net, SKNet, TridentNet and PyConvResNet plug their blocks into it. ``state_dict``
keys follow original Holocron: ``features.{i}`` (stem layers, pool, repeat, then one
``Sequential`` a stage), each block's ``conv.{offset}`` (its layers in
:func:`~holocron_tpu_torch.models.utils.conv_sequence` order) and ``downsample.*``,
and ``head.*``.
"""

from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Type, Union

import torch
from torch import nn

from ...nn.init import kaiming_normal_, lecun_normal_
from ..layers import AvgPool2d, BatchNorm2d
from ..utils import _checkpoint, conv_sequence

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNeXt50_32x4d_Checkpoint",
    "ResNet",
    "ResNet18_Checkpoint",
    "ResNet34_Checkpoint",
    "ResNet50D_Checkpoint",
    "ResNet50_Checkpoint",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet50d",
    "resnet101",
    "resnet152",
    "resnext50_32x4d",
    "resnext101_32x8d",
]

NormLayer = Callable[[int], nn.Module]


def _relu() -> nn.Module:
    return nn.ReLU(inplace=True)


def _zero_scale(norm_layer: NormLayer) -> NormLayer:
    """``norm_layer`` whose scale starts at zero (``zero_init_residual``)."""

    def make(channels: int) -> nn.Module:
        norm = norm_layer(channels)
        nn.init.zeros_(norm.weight)
        return norm

    return make


class _Downsample(nn.Sequential):
    """Shortcut projection (``resnet.py:44-68``): a 1x1 conv and its norm, preceded by a
    ``ceil_mode`` average pool that counts no padding, in place of the conv's stride,
    for ResNet-D (keys ``downsample.1``/``downsample.2`` then)."""

    def __init__(
        self, in_channels: int, out_channels: int, stride: int = 1, avg_downsample: bool = False,
        norm_layer: Optional[NormLayer] = None,
    ) -> None:
        layers: List[nn.Module] = []
        if avg_downsample and stride > 1:
            layers.append(AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False))
            stride = 1
        layers += conv_sequence(in_channels, out_channels, None, norm_layer or BatchNorm2d, kernel_size=1, stride=stride)
        super().__init__(*layers)


class _ResBlock(nn.Module):
    """A residual block: ``activation(conv(x) + shortcut(x))``, where ``conv`` is a
    ``Sequential`` of the block's layers and the shortcut the identity or
    :class:`_Downsample`. ``out_channels`` is the channel count the block returns."""

    expansion = 1

    def __init__(
        self, layers: Sequence[nn.Module], in_channels: int, out_channels: int, stride: int, downsample: bool,
        avg_downsample: bool, act_layer: nn.Module, norm_layer: NormLayer,
    ) -> None:
        super().__init__()
        self.out_channels = out_channels
        self.conv = nn.Sequential(*layers)
        self.downsample = (
            _Downsample(in_channels, out_channels, stride, avg_downsample, norm_layer) if downsample else None
        )
        self.activation = act_layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return self.activation(self.conv(x) + identity)


class BasicBlock(_ResBlock):
    """Two 3x3 convs and a shortcut (``resnet.py:71-127``)."""

    expansion = 1

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: bool = False,
        groups: int = 1,
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
        final_norm = _zero_scale(norm_layer) if zero_init_residual else norm_layer
        common = {"drop_layer": drop_layer, "conv_layer": conv_layer, "kernel_size": 3, "padding": dilation,
                  "groups": groups, "dilation": dilation}
        layers = [
            *conv_sequence(inplanes, planes, act_layer, norm_layer, stride=stride, **common),
            *conv_sequence(planes, planes, None, final_norm, stride=1, **common),
        ]
        super().__init__(layers, inplanes, planes, stride, downsample, avg_downsample, act_layer, norm_layer)


class Bottleneck(_ResBlock):
    """1x1 -> 3x3 -> 1x1 bottleneck and a shortcut (``resnet.py:130-188``); the 3x3 conv
    has ``int(planes * base_width / 64) * groups`` channels in ``groups`` groups."""

    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: bool = False,
        groups: int = 1,
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
        final_norm = _zero_scale(norm_layer) if zero_init_residual else norm_layer
        width = int(planes * (base_width / 64.0)) * groups
        out_channels = planes * self.expansion
        common = {"drop_layer": drop_layer, "conv_layer": conv_layer}
        layers = [
            *conv_sequence(inplanes, width, act_layer, norm_layer, kernel_size=1, **common),
            *conv_sequence(width, width, act_layer, norm_layer, kernel_size=3, stride=stride, padding=dilation,
                           groups=groups, dilation=dilation, **common),
            *conv_sequence(width, out_channels, None, final_norm, kernel_size=1, **common),
        ]
        super().__init__(layers, inplanes, out_channels, stride, downsample, avg_downsample, act_layer, norm_layer)


class _ChannelRepeat(nn.Module):
    """Repeats the channels ``repeats`` times, ``[x, x, ...]`` (TridentNet's input to
    its three branches)."""

    def __init__(self, repeats: int) -> None:
        super().__init__()
        self.repeats = repeats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat(1, self.repeats, 1, 1)


class ResNet(nn.Module):
    """The ResNet container (``resnet.py:191-266``): stem -> optional 3x3 max pool ->
    optional channel repeat -> stages of ``block`` -> global average pool -> linear head.

    Stage ``i`` has ``num_blocks[i]`` blocks of ``planes[i]``; its first block has
    stride 2 (stride 1 in the first stage) and a projection shortcut where the stride
    or the channel count changes. ``block_args`` (a dict, or one a stage) goes to each
    block; it defaults to ``{"groups": 1}``, which matters for blocks whose own default
    differs (SKBottleneck's 32).

    Weights are drawn from ``generator`` on the CPU (convs: fan-out He-normal and zero
    bias; head: LeCun normal and zero bias, as the JAX package's ``nn.Dense``; norms:
    ones and zeros, or a zero scale on each block's last norm under
    ``zero_init_residual``), then moved to ``device``: the card unless the caller asks
    for the CPU (``device="cpu"``).
    """

    def __init__(
        self,
        block: Type[_ResBlock],
        num_blocks: Sequence[int],
        planes: Sequence[int],
        num_classes: int = 10,
        in_channels: int = 3,
        zero_init_residual: bool = False,
        width_per_group: int = 64,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        deep_stem: bool = False,
        stem_pool: bool = True,
        avg_downsample: bool = False,
        num_repeats: int = 1,
        block_args: Optional[Union[Dict[str, Any], Sequence[Dict[str, Any]]]] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.block, self.num_blocks = block, list(num_blocks)
        self.deep_stem, self.stem_pool, self.num_repeats = deep_stem, stem_pool, num_repeats
        act_layer = act_layer or _relu()
        norm_layer = norm_layer or BatchNorm2d
        stem = {"drop_layer": drop_layer, "conv_layer": conv_layer}
        in_planes = 64
        if deep_stem:
            layers = [
                *conv_sequence(in_channels, in_planes // 2, act_layer, norm_layer, kernel_size=3, stride=2, padding=1,
                               **stem),
                *conv_sequence(in_planes // 2, in_planes // 2, act_layer, norm_layer, kernel_size=3, padding=1,
                               **stem),
                *conv_sequence(in_planes // 2, in_planes, act_layer, norm_layer, kernel_size=3, padding=1, **stem),
            ]
        else:
            layers = conv_sequence(in_channels, in_planes, act_layer, norm_layer, kernel_size=7, stride=2, padding=3,
                                   **stem)
        if stem_pool:
            layers.append(nn.MaxPool2d(3, 2, 1))
        if num_repeats > 1:
            layers.append(_ChannelRepeat(num_repeats))

        if block_args is None:
            block_args = {"groups": 1}
        if not isinstance(block_args, (list, tuple)):
            block_args = [block_args] * len(num_blocks)
        channels = in_planes * num_repeats  # what the stages see; in_planes is the nominal width
        stride = 1
        for nb, stage_planes, args in zip(num_blocks, planes, block_args):
            blocks = []
            for j in range(nb):
                blocks.append(block(
                    channels, stage_planes, stride=stride if j == 0 else 1,
                    downsample=j == 0 and (stride != 1 or in_planes != stage_planes * block.expansion),
                    base_width=width_per_group, act_layer=act_layer, norm_layer=norm_layer, drop_layer=drop_layer,
                    avg_downsample=avg_downsample, zero_init_residual=zero_init_residual, **args,
                ))
                channels = blocks[-1].out_channels
            layers.append(nn.Sequential(*blocks))
            in_planes = stage_planes * block.expansion
            stride = 2
        self.features = nn.Sequential(*layers)
        self.head = nn.Linear(channels, num_classes)
        _init_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        return self.head(x.mean(dim=(2, 3)))


@torch.no_grad()
def _init_weights(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Fan-out He-normal conv weights (every parameter named ``weight`` of a conv-like
    module, TridentConv2d's shared one too) and zero conv biases, then a LeCun-normal
    head with a zero bias, in module order, from ``generator``."""
    for m in model.modules():
        weight = getattr(m, "weight", None)
        if isinstance(weight, nn.Parameter) and weight.ndim == 4:
            kaiming_normal_(weight, generator=generator)
            if isinstance(getattr(m, "bias", None), nn.Parameter):
                nn.init.zeros_(m.bias)
    lecun_normal_(model.head.weight, generator=generator)
    nn.init.zeros_(model.head.bias)


def _resnet(block: Type[_ResBlock], num_blocks: Sequence[int], planes: Sequence[int], pretrained: bool,
            **kwargs: Any) -> ResNet:
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    return ResNet(block, num_blocks, planes, **kwargs)


_TRAIN_ARGS = (
    "./imagenette2-320/ --arch {} --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
    " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
    " --opt adamw --weight-decay 5e-2"
)
_COMMIT = "6e32c5b578711a2ef3731a8f8c61760ed9f03e58"
_RELEASE = "https://github.com/frgfm/Holocron/releases/download/v0.2.1/"


def _release(arch: str, file: str, acc1: float, acc5: float, sha256: str, size: int, num_params: int):
    """A checkpoint of the v0.2.1 release, trained by the classification reference."""
    return _checkpoint(arch, _RELEASE + file, acc1, acc5, sha256, size, num_params, _COMMIT, _TRAIN_ARGS.format(arch))


class ResNet18_Checkpoint(Enum):
    IMAGENETTE = _release("resnet18", "resnet18_224-fc07006c.pth", 0.9361, 0.9946,
                          "fc07006c894cac8cf380fed699bc5a68463698753c954632f52bb8595040f781", 44787043, 11181642)
    DEFAULT = IMAGENETTE


class ResNet34_Checkpoint(Enum):
    IMAGENETTE = _release("resnet34", "resnet34_224-412b0792.pth", 0.9381, 0.9949,
                          "412b07927cc1938ee3add8d0f6bb18b42786646182f674d75f1433d086914485", 85267035, 21289802)
    DEFAULT = IMAGENETTE


class ResNet50_Checkpoint(Enum):
    IMAGENETTE = _release("resnet50", "resnet50_224-5b913f0b.pth", 0.9378, 0.9954,
                          "5b913f0b8148b483ba15541ab600cf354ca42b326e4896c4c3dbc51eb1e80e70", 94384682, 23528522)
    DEFAULT = IMAGENETTE


class ResNet50D_Checkpoint(Enum):
    IMAGENETTE = _release("resnet50d", "resnet50d_224-6218d936.pth", 0.9465, 0.9952,
                          "6218d936fa67c0047f1ec65564213db538aa826d84f2df1d4fa3224531376e6c", 94464810, 23547754)
    DEFAULT = IMAGENETTE


class ResNeXt50_32x4d_Checkpoint(Enum):
    IMAGENETTE = _release("resnext50_32x4d", "resnext50_32x4d_224-5832c4ce.pth", 0.9455, 0.9949,
                          "5832c4ce33522a9eb7a8b5abe31cf30621721a92d4f99b4b332a007d81d071fe", 92332638, 23000394)
    DEFAULT = IMAGENETTE


_STAGES = [64, 128, 256, 512]


def resnet18(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNet-18 (``resnet.py:376-379``)."""
    return _resnet(BasicBlock, [2, 2, 2, 2], _STAGES, pretrained, **kwargs)


def resnet34(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNet-34 (``resnet.py:382-385``)."""
    return _resnet(BasicBlock, [3, 4, 6, 3], _STAGES, pretrained, **kwargs)


def resnet50(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNet-50 (``resnet.py:388-391``)."""
    return _resnet(Bottleneck, [3, 4, 6, 3], _STAGES, pretrained, **kwargs)


def resnet50d(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNet-50D: the deep stem and the average-pool shortcut (``resnet.py:394-406``)."""
    return _resnet(Bottleneck, [3, 4, 6, 3], _STAGES, pretrained, deep_stem=True, avg_downsample=True, **kwargs)


def resnet101(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNet-101 (``resnet.py:409-412``)."""
    return _resnet(Bottleneck, [3, 4, 23, 3], _STAGES, pretrained, **kwargs)


def resnet152(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNet-152 (``resnet.py:415-418``)."""
    return _resnet(Bottleneck, [3, 8, 86, 3], _STAGES, pretrained, **kwargs)


def resnext50_32x4d(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNeXt-50 32x4d (``resnet.py:421-429``)."""
    kwargs["width_per_group"] = 4
    return _resnet(Bottleneck, [3, 4, 6, 3], _STAGES, pretrained, block_args={"groups": 32}, **kwargs)


def resnext101_32x8d(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """ResNeXt-101 32x8d (``resnet.py:432-440``)."""
    kwargs["width_per_group"] = 8
    return _resnet(Bottleneck, [3, 4, 23, 3], _STAGES, pretrained, block_args={"groups": 32}, **kwargs)
