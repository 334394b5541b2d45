"""ReXNet (`Han et al. <https://arxiv.org/pdf/2007.00992.pdf>`_), the port of
``holocron_tpu/models/classification/rexnet.py``.

Blocks: an optional SiLU 1x1 expansion, a depthwise 3x3, squeeze-and-excitation,
ReLU6 and a linear 1x1 projection, with the partial residual that adds the input to
the first ``in_channels`` output channels; widths grow linearly with depth. BN stays
after each conv (the JAX package has no ReXNet ``reparametrize``). ``state_dict`` keys
follow original Holocron: ``features.{i}`` (the stem's conv, norm and activation, one
:class:`ReXBlock` a block with its layers in ``conv.{offset}``, the penultimate conv,
norm and activation), ``pool`` and ``head.1``, the keys ``_convert_rexnet`` reads.
"""

from enum import Enum
from math import ceil
from typing import Any, Callable, List, Optional, Union

import torch
from torch import nn

from ...nn.init import kaiming_normal_, lecun_normal_
from ...nn.modules.downsample import GlobalAvgPool2d
from ..checkpoints import Checkpoint, Dataset
from ..layers import BatchNorm2d
from ..utils import _checkpoint, _pretrained, conv_sequence

__all__ = [
    "ReXBlock",
    "ReXNet",
    "ReXNet1_0x_Checkpoint",
    "ReXNet1_3x_Checkpoint",
    "ReXNet1_5x_Checkpoint",
    "ReXNet2_0x_Checkpoint",
    "ReXNet2_2x_Checkpoint",
    "SEBlock",
    "rexnet1_0x",
    "rexnet1_3x",
    "rexnet1_5x",
    "rexnet2_0x",
    "rexnet2_2x",
]

NormLayer = Callable[[int], nn.Module]


class SEBlock(nn.Module):
    """Squeeze-and-excitation gate (``rexnet.py:38-61``): the mean over H and W, a 1x1
    conv to ``channels // se_ratio`` with its norm and ``act_layer``, a biased 1x1 conv
    back to ``channels`` and a sigmoid, which scales ``x``. In train mode the norm sees
    ``N x C x 1 x 1`` maps, so its batch statistics come from the batch alone."""

    def __init__(self, channels: int, se_ratio: int = 12, act_layer: Optional[nn.Module] = None,
                 norm_layer: Optional[NormLayer] = None) -> None:
        super().__init__()
        mid = channels // se_ratio
        self.conv = nn.Sequential(
            *conv_sequence(channels, mid, act_layer or nn.ReLU6(inplace=True), norm_layer or BatchNorm2d, kernel_size=1),
            *conv_sequence(mid, channels, nn.Sigmoid(), None, kernel_size=1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv(x.mean(dim=(2, 3), keepdim=True))


class ReXBlock(nn.Module):
    """Inverted bottleneck with a partial residual (``rexnet.py:64-100``): a SiLU 1x1
    expansion by ``t`` when ``t != 1``, a depthwise 3x3 with ``stride``, SE, ReLU6 and a
    linear 1x1 projection to ``channels``. At stride 1 with ``in_channels <=
    channels``, the input is added to the first ``in_channels`` output channels."""

    def __init__(
        self,
        in_channels: int,
        channels: int,
        t: int,
        stride: int,
        use_se: bool = True,
        se_ratio: int = 12,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
    ) -> None:
        super().__init__()
        self.in_channels, self.t = in_channels, t
        self.use_shortcut = stride == 1 and in_channels <= channels
        norm_layer = norm_layer or BatchNorm2d
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer}
        layers: List[nn.Module] = []
        dw_channels = in_channels
        if t != 1:
            dw_channels = in_channels * t
            layers += conv_sequence(in_channels, dw_channels, nn.SiLU(inplace=True), kernel_size=1, **common)
        layers += conv_sequence(dw_channels, dw_channels, None, kernel_size=3, stride=stride, padding=1,
                                groups=dw_channels, **common)
        if use_se:
            layers.append(SEBlock(dw_channels, se_ratio, act_layer, norm_layer))
        layers.append(act_layer or nn.ReLU6(inplace=True))
        layers += conv_sequence(dw_channels, channels, None, kernel_size=1, **common)
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        if self.use_shortcut:
            # out[:, :c] += x on the channel axis, out of place (out is an autograd tensor,
            # channels_last on the card)
            c = self.in_channels
            out = torch.cat((out[:, :c] + x, out[:, c:]), dim=1)
        return out


class ReXNet(nn.Module):
    """The ReXNet body (``rexnet.py:103-163``): a SiLU stride-2 stem, ``16 * depth_mult``
    blocks of linearly growing width (SE from the third stage), a SiLU 1x1 conv to
    ``int(1280 * width_mult)``, global average pooling, dropout and a linear head.

    Weights are drawn from ``generator`` on the CPU (convs: fan-out He-normal, zero
    bias; head: LeCun normal, zero bias, as the JAX package's ``nn.Dense``; norms: ones
    and zeros), then moved to ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``). The norms are torch's with momentum 0.1, the JAX package's 0.9
    in flax's convention.
    """

    def __init__(
        self,
        width_mult: float = 1.0,
        depth_mult: float = 1.0,
        num_classes: int = 1000,
        in_channels: int = 3,
        in_planes: int = 16,
        final_planes: int = 180,
        use_se: bool = True,
        se_ratio: int = 12,
        dropout_ratio: float = 0.2,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.width_mult, self.depth_mult, self.use_se = width_mult, depth_mult, use_se
        act_layer = act_layer or nn.SiLU(inplace=True)
        norm_layer = norm_layer or BatchNorm2d
        num_blocks = [ceil(e * depth_mult) for e in [1, 2, 2, 3, 3, 5]]
        strides = []
        for idx, s in enumerate([1, 2, 2, 2, 1, 2]):
            strides.extend([s] + [1] * (num_blocks[idx] - 1))
        depth = sum(num_blocks)

        stem_channel = 32 / width_mult if width_mult < 1.0 else 32
        inplanes = in_planes / width_mult if width_mult < 1.0 else in_planes
        chans = [round(width_mult * stem_channel)]
        chans.extend(round(width_mult * (inplanes + idx * final_planes / depth)) for idx in range(depth))
        ses = [False] * (num_blocks[0] + num_blocks[1]) + [use_se] * sum(num_blocks[2:])

        common = {"norm_layer": norm_layer, "drop_layer": drop_layer}
        layers: List[nn.Module] = conv_sequence(in_channels, chans[0], act_layer, kernel_size=3, stride=2, padding=1,
                                                **common)
        t = 1
        for c_in, c, s, se in zip(chans[:-1], chans[1:], strides, ses):
            layers.append(ReXBlock(c_in, c, t, s, se, se_ratio, norm_layer=norm_layer, drop_layer=drop_layer))
            t = 6
        pen_channels = int(width_mult * 1280)
        layers += conv_sequence(chans[-1], pen_channels, act_layer, kernel_size=1, **common)
        self.features = nn.Sequential(*layers)
        self.pool = GlobalAvgPool2d(flatten=True)
        self.head = nn.Sequential(nn.Dropout(dropout_ratio), nn.Linear(pen_channels, num_classes))
        _init_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.pool(self.features(x)))


@torch.no_grad()
def _init_weights(model: ReXNet, generator: Optional[torch.Generator]) -> None:
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            kaiming_normal_(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    lecun_normal_(model.head[1].weight, generator=generator)
    nn.init.zeros_(model.head[1].bias)


def _rexnet(width_mult: float, depth_mult: float, pretrained: bool, checkpoint: Optional[Checkpoint],
            progress: bool, default: Optional[Checkpoint], **kwargs: Any) -> ReXNet:
    return _pretrained(ReXNet(width_mult, depth_mult, **kwargs), pretrained, checkpoint, progress, default)


_TRAIN_ARGS = (
    "./imagenette2-320/ --arch {} --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
    " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
    " --opt adamw --weight-decay 5e-2"
)
_COMMIT = "d4a59999179b42fc0d3058ac6b76cc41f49dd56e"
_V012 = "https://github.com/frgfm/Holocron/releases/download/v0.1.2/"
_V021 = "https://github.com/frgfm/Holocron/releases/download/v0.2.1/"


def _imagenet(arch: str, file: str, acc1: float, acc5: float, sha256: str, num_params: int):
    """A port of Ross Wightman's ImageNet weights (release v0.1.2)."""
    return _checkpoint(arch, _V012 + file, acc1, acc5, sha256, 14351299, num_params, dataset=Dataset.IMAGENET1K)


def _imagenette(arch: str, file: str, acc1: float, acc5: float, sha256: str, size: int, num_params: int,
                train_args: Optional[str] = None):
    """A checkpoint of the v0.2.1 release, trained by the classification reference."""
    return _checkpoint(arch, _V021 + file, acc1, acc5, sha256, size, num_params, _COMMIT,
                       train_args or _TRAIN_ARGS.format(arch))


class ReXNet1_0x_Checkpoint(Enum):
    IMAGENET1K = _imagenet("rexnet1_0x", "rexnet1_0x_224-ab7b9733.pth", 0.7786, 0.93870,
                           "ab7b973341a59832099f6ee2a41eb51121b287ad4adaae8b2cd8dd92ef058f01", 4796186)
    IMAGENETTE = _imagenette("rexnet1_0x", "rexnet1_0x_224-7c19fd53.pth", 0.9439, 0.9962,
                             "7c19fd53a5433927e9b4b22fa9cb0833eb1e4c3254b4079b6818fce650a77943", 14351299, 3527996)
    DEFAULT = IMAGENET1K


class ReXNet1_3x_Checkpoint(Enum):
    IMAGENET1K = _imagenet("rexnet1_3x", "rexnet1_3x_224-95479104.pth", 0.7950, 0.9468,
                           "95479104024ce294abbdd528df62bd1a23e67a9db2956e1d6cdb9a9759dc1c69", 7556198)
    IMAGENETTE = _imagenette("rexnet1_3x", "rexnet1_3x_224-cf85ae91.pth", 0.9488, 0.9939,
                             "cf85ae919cbc9484f9fa150106451f68d2e84c73f1927a1b80aeeaa243ccd65b", 23920480, 5907848)
    DEFAULT = IMAGENET1K


class ReXNet1_5x_Checkpoint(Enum):
    IMAGENET1K = _imagenet("rexnet1_5x", "rexnet1_5x_224-c42a16ac.pth", 0.8031, 0.9517,
                           "c42a16ac73470d64852b8317ba9e875c833595a90a086b90490a696db9bb6a96", 9727562)
    IMAGENETTE = _imagenette("rexnet1_5x", "rexnet1_5x_224-4b9d7a59.pth", 0.9447, 0.9962,
                             "4b9d7a5901da6c2b9386987a6120bc86089d84df7727e43b78a4dfe2fc1c719a", 31625286, 7825772)
    DEFAULT = IMAGENET1K


class ReXNet2_0x_Checkpoint(Enum):
    IMAGENET1K = _imagenet("rexnet2_0x", "rexnet2_0x_224-c8802402.pth", 0.8031, 0.9517,
                           "c8802402442551c77fe3874f84d4d7eb1bd67cce274375db11a869ed074a1089", 16365244)
    IMAGENETTE = _imagenette("rexnet2_0x", "rexnet2_0x_224-3f00641e.pth", 0.9524, 0.9957,
                             "3f00641e48a6d1d3c9794534eb372467e0730700498933c9e79e60c838671d13", 55724412, 13829854)
    DEFAULT = IMAGENETTE


class ReXNet2_2x_Checkpoint(Enum):
    IMAGENETTE = _imagenette(
        "rexnet2_2x", "rexnet2_2x_224-b23b2847.pth", 0.9544, 0.9946,
        "b23b28475329e413bfb491503460db8f47a838ec8dcdc5d13ade6f40ee5841a6", 67217933, 16694966,
        "./imagenette2-320/ --arch rexnet2_2x --batch-size 32 --grad-acc 2 --mixup-alpha 0.2 --amp --device 0"
        " --epochs 100 --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176"
        " --val-resize-size 232 --opt adamw --weight-decay 5e-2",
    )
    DEFAULT = IMAGENETTE


def rexnet1_0x(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
               **kwargs: Any) -> ReXNet:
    """ReXNet-1.0x (``rexnet.py:309-312``), the API's default model."""
    return _rexnet(1, 1, pretrained, checkpoint, progress, ReXNet1_0x_Checkpoint.DEFAULT.value, **kwargs)


def rexnet1_3x(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
               **kwargs: Any) -> ReXNet:
    """ReXNet-1.3x (``rexnet.py:315-318``)."""
    return _rexnet(1.3, 1, pretrained, checkpoint, progress, ReXNet1_3x_Checkpoint.DEFAULT.value, **kwargs)


def rexnet1_5x(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
               **kwargs: Any) -> ReXNet:
    """ReXNet-1.5x (``rexnet.py:321-324``)."""
    return _rexnet(1.5, 1, pretrained, checkpoint, progress, ReXNet1_5x_Checkpoint.DEFAULT.value, **kwargs)


def rexnet2_0x(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
               **kwargs: Any) -> ReXNet:
    """ReXNet-2.0x (``rexnet.py:327-330``)."""
    return _rexnet(2, 1, pretrained, checkpoint, progress, ReXNet2_0x_Checkpoint.DEFAULT.value, **kwargs)


def rexnet2_2x(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
               **kwargs: Any) -> ReXNet:
    """ReXNet-2.2x (``rexnet.py:333-336``)."""
    return _rexnet(2.2, 1, pretrained, checkpoint, progress, ReXNet2_2x_Checkpoint.DEFAULT.value, **kwargs)
