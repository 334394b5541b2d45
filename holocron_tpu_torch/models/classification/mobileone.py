"""MobileOne (`Vasu et al. <https://arxiv.org/pdf/2206.04040.pdf>`_), s0-s3, the port of
``holocron_tpu/models/classification/mobileone.py``.

Train form: each block is a depthwise block (an identity BN branch at stride 1, a 1x1
depthwise conv+BN branch and ``k`` 3x3 depthwise conv+BN branches, summed) and a
pointwise block (an identity BN branch where the widths match and ``k`` 1x1 conv+BN
branches, summed), each followed by a ReLU. :meth:`MobileOne.reparametrize` folds each
block, in place, into one biased conv, as original Holocron does. ``state_dict`` keys
follow original Holocron: ``features.0`` the first block and ``features.{s + 1}.{j}``
the stages' blocks, each ``.0`` (depthwise) ``.2`` (pointwise) holding its branches
in order (``.{i}`` a BN, or ``.{i}.0`` / ``.{i}.1`` a conv and its BN) or, in deploy
form, the one conv at ``.0``; and ``head``.
"""

from enum import Enum
from typing import Any, Optional, Sequence, Union

import torch
from torch import nn

from ...nn.init import kaiming_normal_, lecun_normal_
from ..layers import BatchNorm2d
from ..checkpoints import Checkpoint
from ..utils import _checkpoint, _pretrained, fuse_conv_bn

__all__ = [
    "DepthConvBlock",
    "MobileOne",
    "MobileOneBlock",
    "MobileOne_S0_Checkpoint",
    "MobileOne_S1_Checkpoint",
    "MobileOne_S2_Checkpoint",
    "MobileOne_S3_Checkpoint",
    "PointConvBlock",
    "mobileone_s0",
    "mobileone_s1",
    "mobileone_s2",
    "mobileone_s3",
]


def _branch(in_channels: int, out_channels: int, kernel_size: int, stride: int, groups: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(in_channels, out_channels, kernel_size, stride, kernel_size // 2, groups=groups, bias=False),
        BatchNorm2d(out_channels),
    )


class _BranchSum(nn.ModuleList):
    """The sum of the branches on one input; after reparametrization, one conv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = iter(self)
        out = next(branches)(x)
        for branch in branches:
            out = out + branch(x)
        return out

    @property
    def deployed(self) -> bool:
        return len(self) == 1 and not isinstance(self[0], (nn.Sequential, nn.BatchNorm2d))

    def _replace(self, weight: torch.Tensor, bias: torch.Tensor, stride: int, groups: int) -> None:
        out_c, _, kh, _ = weight.shape
        in_c = weight.shape[1] * groups
        conv = nn.Conv2d(in_c, out_c, kh, stride, kh // 2, groups=groups, bias=True, device=weight.device,
                         dtype=weight.dtype)
        conv.weight.copy_(weight)
        conv.bias.copy_(bias)
        while len(self):
            del self[0]
        self.append(conv)


def _identity_bn(bn: nn.BatchNorm2d):
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return scale, bn.bias - scale * bn.running_mean


def _fuse(seq: nn.Sequential):
    conv, bn = seq
    return fuse_conv_bn(conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var, eps=bn.eps)


class DepthConvBlock(_BranchSum):
    """The reparametrizable depthwise block (``mobileone.py:35-74``)."""

    def __init__(self, channels: int, num_blocks: int, stride: int = 1) -> None:
        layers = [BatchNorm2d(channels)] if stride == 1 else []
        layers.append(_branch(channels, channels, 1, stride, channels))
        layers.extend(_branch(channels, channels, 3, stride, channels) for _ in range(num_blocks))
        super().__init__(layers)
        self.channels, self.stride = channels, stride

    @torch.no_grad()
    def reparametrize(self) -> None:
        """One biased 3x3 depthwise conv (``_fuse_depth_block``, ``mobileone.py:126-157``):
        the identity BN on the kernel's centre tap, the 1x1 branch on the centre (at
        stride 2 too), the 3x3 branches added."""
        if self.deployed:
            raise AssertionError("the block is already reparametrized")
        branches = list(self)
        dtype, device = branches[-1][0].weight.dtype, branches[-1][0].weight.device
        kernel = torch.zeros((self.channels, 1, 3, 3), dtype=dtype, device=device)
        bias = torch.zeros((self.channels,), dtype=dtype, device=device)
        if isinstance(branches[0], nn.BatchNorm2d):
            scale, shift = _identity_bn(branches.pop(0))
            kernel[:, 0, 1, 1] += scale
            bias = bias + shift
        k1, b1 = _fuse(branches[0])
        kernel[:, :, 1:2, 1:2] += k1
        bias = bias + b1
        for branch in branches[1:]:
            k3, b3 = _fuse(branch)
            kernel = kernel + k3
            bias = bias + b3
        self._replace(kernel, bias, self.stride, self.channels)


class PointConvBlock(_BranchSum):
    """The reparametrizable pointwise block (``mobileone.py:77-105``)."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int) -> None:
        layers = [BatchNorm2d(out_channels)] if out_channels == in_channels else []
        layers.extend(_branch(in_channels, out_channels, 1, 1, 1) for _ in range(num_blocks))
        super().__init__(layers)
        self.in_channels, self.out_channels = in_channels, out_channels

    @torch.no_grad()
    def reparametrize(self) -> None:
        """One biased 1x1 conv (``_fuse_point_block``, ``mobileone.py:160-181``): the
        identity BN as a diagonal (only where the widths match), the branches added."""
        if self.deployed:
            raise AssertionError("the block is already reparametrized")
        branches = list(self)
        dtype, device = branches[-1][0].weight.dtype, branches[-1][0].weight.device
        kernel = torch.zeros((self.out_channels, self.in_channels, 1, 1), dtype=dtype, device=device)
        bias = torch.zeros((self.out_channels,), dtype=dtype, device=device)
        if isinstance(branches[0], nn.BatchNorm2d):
            scale, shift = _identity_bn(branches.pop(0))
            idx = torch.arange(self.in_channels, device=device)
            kernel[idx, idx, 0, 0] += scale
            bias = bias + shift
        for branch in branches:
            k, b = _fuse(branch)
            kernel = kernel + k
            bias = bias + b
        self._replace(kernel, bias, 1, 1)


class MobileOneBlock(nn.Sequential):
    """Depthwise block, ReLU, pointwise block, ReLU (``mobileone.py:108-123``)."""

    def __init__(self, in_channels: int, out_channels: int, overparam_factor: int = 1, stride: int = 1) -> None:
        super().__init__(
            DepthConvBlock(in_channels, overparam_factor, stride),
            nn.ReLU(inplace=True),
            PointConvBlock(in_channels, out_channels, overparam_factor),
            nn.ReLU(inplace=True),
        )


class MobileOne(nn.Module):
    """The MobileOne body (``mobileone.py:184-216``): a stride-2 block to
    ``min(64, planes[0])`` channels (its depthwise block on the input's channels), four
    stages whose first block has stride 2, global average pooling and a linear head.

    Weights are drawn from ``generator`` on the CPU (convs: fan-out He-normal; head:
    LeCun normal and zero bias, as the JAX package's ``nn.Dense``; norms: ones and
    zeros), then moved to ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``).
    """

    def __init__(
        self,
        num_blocks: Sequence[int],
        width_multipliers: Sequence[float],
        overparam_factor: int = 1,
        num_classes: int = 10,
        in_channels: int = 3,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_blocks, self.overparam_factor = list(num_blocks), overparam_factor
        planes = [round(mult * chans) for mult, chans in zip(width_multipliers, [64, 128, 256, 512])]
        in_planes = min(64, planes[0])
        layers = [MobileOneBlock(in_channels, in_planes, overparam_factor, 2)]
        for nb, out_planes in zip(num_blocks, planes):
            stage = []
            for j in range(nb):
                stage.append(MobileOneBlock(in_planes, out_planes, overparam_factor, 2 if j == 0 else 1))
                in_planes = out_planes
            layers.append(nn.Sequential(*stage))
        self.features = nn.Sequential(*layers)
        self.head = nn.Linear(in_planes, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_(m.weight, generator=generator)
        lecun_normal_(self.head.weight, generator=generator)
        nn.init.zeros_(self.head.bias)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x).mean(dim=(2, 3)))

    def reparametrize(self) -> "MobileOne":
        """Folds every block into its deploy form, in place (``mobileone.py:218-237``),
        from the BN running statistics."""
        for m in self.modules():
            if isinstance(m, (DepthConvBlock, PointConvBlock)):
                m.reparametrize()
        return self


def _mobileone(width_multipliers: Sequence[float], overparam_factor: int, pretrained: bool,
               checkpoint: Optional[Checkpoint], progress: bool, default: Optional[Checkpoint], **kwargs: Any) -> MobileOne:
    model = MobileOne([2, 8, 10, 1], width_multipliers, overparam_factor, **kwargs)
    return _pretrained(model, pretrained, checkpoint, progress, default)


class MobileOne_S0_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="mobileone_s0",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/mobileone_s0_224-9ddd1fe9.pth",
        acc1=0.8808,
        acc5=0.9883,
        sha256="9ddd1fe9d6c0a73d3c4d51d3c967a8a27ff5e545705afc557b4d4ac0f34395cb",
        size=17708169,
        num_params=4277991,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch mobileone_s0 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class MobileOne_S1_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="mobileone_s1",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/mobileone_s1_224-d4ec5433.pth",
        acc1=0.9126,
        acc5=0.9918,
        sha256="d4ec5433cff3d55d562b7a35fc0c95568ff8f4591bf822dd3e699535bdff90eb",
        size=14594817,
        num_params=3555188,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch mobileone_s1 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class MobileOne_S2_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="mobileone_s2",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/mobileone_s2_224-b748859c.pth",
        acc1=0.9131,
        acc5=0.9921,
        sha256="b748859c45a636ea22f0f68a3b7e75e5fb6ffb31178a5a3137931a21b4c41697",
        size=23866479,
        num_params=5854324,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch mobileone_s2 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class MobileOne_S3_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="mobileone_s3",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/mobileone_s3_224-7f357baf.pth",
        acc1=0.9106,
        acc5=0.9931,
        sha256="7f357baf0754136b4a02e7aec4129874db93ee462f43588b77def730db0b2bca",
        size=33080943,
        num_params=8140276,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch mobileone_s3 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


def mobileone_s0(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
                 **kwargs: Any) -> MobileOne:
    """MobileOne-S0 (``mobileone.py:323-326``)."""
    return _mobileone([0.75, 1.0, 1.0, 2.0], 4, pretrained, checkpoint, progress, MobileOne_S0_Checkpoint.DEFAULT.value, **kwargs)


def mobileone_s1(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
                 **kwargs: Any) -> MobileOne:
    """MobileOne-S1 (``mobileone.py:329-332``)."""
    return _mobileone([1.5, 1.5, 2.0, 2.5], 1, pretrained, checkpoint, progress, MobileOne_S1_Checkpoint.DEFAULT.value, **kwargs)


def mobileone_s2(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
                 **kwargs: Any) -> MobileOne:
    """MobileOne-S2 (``mobileone.py:335-338``)."""
    return _mobileone([1.5, 2.0, 2.5, 4.0], 1, pretrained, checkpoint, progress, MobileOne_S2_Checkpoint.DEFAULT.value, **kwargs)


def mobileone_s3(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
                 **kwargs: Any) -> MobileOne:
    """MobileOne-S3 (``mobileone.py:341-344``)."""
    return _mobileone([2.0, 2.5, 3.0, 4.0], 1, pretrained, checkpoint, progress, MobileOne_S3_Checkpoint.DEFAULT.value, **kwargs)
