"""RepVGG (`Ding et al. <https://arxiv.org/pdf/2101.03697.pdf>`_), the port of
``holocron_tpu/models/classification/repvgg.py``.

Train form: per block, the sum of a 3x3 conv+BN branch, a 1x1 conv+BN branch and, for
stride-1 same-width blocks, an identity BN branch, then the activation.
:meth:`RepVGG.reparametrize` folds every block in place into one biased 3x3 conv, as
original Holocron does, and on request the stem into its space-to-depth form (a 2x2
stride-1 conv over 4x the channels, the JAX package's ``s2d_stem`` / ``s2d_input``).
``state_dict`` keys follow original Holocron: ``features.{s}.{j}.branches.{0,1,2}`` in
train form, ``features.{s}.{j}.branches`` (a biased conv) in deploy form, and ``head.*``.
"""

from enum import Enum
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from ...nn.init import kaiming_normal_, lecun_normal_
from ..layers import BatchNorm2d
from ..checkpoints import Checkpoint
from ..utils import _checkpoint, _pretrained, fold_s2d_kernel, fuse_conv_bn, space_to_depth_padded

__all__ = [
    "RepBlock",
    "RepVGG",
    "RepVGG_A0_Checkpoint",
    "RepVGG_A1_Checkpoint",
    "RepVGG_A2_Checkpoint",
    "RepVGG_B0_Checkpoint",
    "RepVGG_B1_Checkpoint",
    "RepVGG_B2_Checkpoint",
    "repvgg_a0",
    "repvgg_a1",
    "repvgg_a2",
    "repvgg_b0",
    "repvgg_b1",
    "repvgg_b2",
    "repvgg_b3",
]


class RepBlock(nn.Module):
    """One RepVGG block (``repvgg.py:43-114``).

    ``s2d`` (deploy form only, set by :meth:`RepVGG.reparametrize`): the block's conv is
    the 2x2 stride-1 fold of its 3x3 stride-2 one (:func:`fold_s2d_kernel`) over the
    space-to-depth(2) input, padded by one zero row and column on top and left: the same
    sums over 4x the input channels. ``s2d_input`` (with ``s2d``): the input is already
    rearranged, ``(N, 4C, H/2, W/2)`` in
    :func:`~holocron_tpu_torch.nn.functional.concat_downsample2d`'s channel order
    (:func:`~holocron_tpu_torch.transforms.functional.space_to_depth_batch` on the host).
    """

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        identity: bool = True,
        act_layer: Optional[Callable] = None,
    ) -> None:
        super().__init__()
        if identity and inplanes != planes:
            raise ValueError("The number of input and output channels must be identical if identity is used")
        self.inplanes, self.planes, self.stride = inplanes, planes, stride
        branches = [
            nn.Sequential(nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False), BatchNorm2d(planes)),
            nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, 0, bias=False), BatchNorm2d(planes)),
        ]
        if identity:
            branches.append(BatchNorm2d(planes))
        self.branches: nn.Module = nn.ModuleList(branches)
        self.activation = act_layer or F.relu
        self.s2d = self.s2d_input = False

    def _s2d_padded(self, x: torch.Tensor) -> torch.Tensor:
        """The folded conv's input: ``x`` rearranged (unless ``s2d_input``) and padded on
        top and left, NCHW in the channels-last memory format."""
        if self.s2d_input:
            if x.shape[1] % 4:
                raise ValueError("s2d_input expects a space-to-depth(2) batch (channels % 4 == 0)")
        elif self.stride != 2 or x.shape[2] % 2 or x.shape[3] % 2:
            raise ValueError("s2d deploy form requires stride 2 and even input H/W")
        return space_to_depth_padded(x.permute(0, 2, 3, 1), s2d=not self.s2d_input).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(self.branches, nn.ModuleList):  # deploy form: one conv (float or int8)
            if self.s2d:
                x = self._s2d_padded(x)
            return self.activation(self.branches(x))
        out = self.branches[0](x) + self.branches[1](x)
        if len(self.branches) == 3:
            out = out + self.branches[2](x)
        return self.activation(out)

    @torch.no_grad()
    def reparametrize(self) -> None:
        """Replaces the branches by one biased 3x3 conv (``_fuse_rep_block``,
        ``repvgg.py:117-145``), from the BN running statistics."""
        if not isinstance(self.branches, nn.ModuleList):
            raise AssertionError("model is already reparametrized")
        (conv3, bn3), (conv1, bn1) = self.branches[0], self.branches[1]
        k3, b3 = fuse_conv_bn(conv3.weight, bn3.weight, bn3.bias, bn3.running_mean, bn3.running_var, eps=bn3.eps)
        k1, b1 = fuse_conv_bn(conv1.weight, bn1.weight, bn1.bias, bn1.running_mean, bn1.running_var, eps=bn1.eps)
        weight = k3.clone()
        weight[:, :, 1:2, 1:2] += k1
        bias = b3 + b1
        if len(self.branches) == 3:
            bn = self.branches[2]
            scale_factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            idx = torch.arange(self.planes, device=weight.device)
            weight[idx, idx, 1, 1] += scale_factor
            bias = bias + bn.bias - scale_factor * bn.running_mean
        conv = nn.Conv2d(self.inplanes, self.planes, 3, self.stride, 1, bias=True, device=weight.device, dtype=weight.dtype)
        conv.weight.copy_(weight)
        conv.bias.copy_(bias)
        self.branches = conv

    @torch.no_grad()
    def fold_s2d(self, s2d_input: bool = False) -> None:
        """Replaces the deploy conv (3x3, stride 2, pad 1) by its space-to-depth fold,
        a biased 2x2 stride-1 conv over 4x the channels (``repvgg.py:221-226``)."""
        conv = self.branches
        if isinstance(conv, nn.ModuleList):
            raise AssertionError("reparametrize the block first")
        if conv.kernel_size != (3, 3) or conv.stride != (2, 2) or conv.padding != (1, 1):
            raise ValueError("s2d deploy form requires stride 2 and even input H/W")
        folded = nn.Conv2d(4 * conv.in_channels, conv.out_channels, 2, 1, 0, bias=True,
                           device=conv.weight.device, dtype=conv.weight.dtype)
        folded.weight.copy_(fold_s2d_kernel(conv.weight))
        folded.bias.copy_(conv.bias)
        self.branches, self.s2d, self.s2d_input = folded, True, s2d_input


class RepVGG(nn.Module):
    """RepVGG body: staged RepBlocks, global average pool, linear head
    (``repvgg.py:156-203``). Stage ``s`` opens with a stride-2 block without identity,
    followed by ``num_blocks[s]`` stride-1 identity blocks.

    Weights are drawn from ``generator`` on the CPU (conv: fan-out He-normal; head:
    LeCun normal and zero bias, as the JAX package's ``nn.Dense``), then moved to
    ``device``: the card unless the caller asks for the CPU (``device="cpu"``).
    """

    def __init__(
        self,
        num_blocks: Sequence[int],
        planes: Sequence[int],
        width_multiplier: float,
        final_width_multiplier: float,
        num_classes: int = 10,
        in_channels: int = 3,
        act_layer: Optional[Callable] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        if len(num_blocks) != len(planes):
            raise AssertionError("the length of `num_blocks` and `planes` are expected to be the same")
        chans = [int(min(1, width_multiplier) * planes[0])]
        chans.extend(int(width_multiplier * chan) for chan in planes[1:-1])
        chans.append(int(final_width_multiplier * planes[-1]))

        stages = []
        in_chan = in_channels
        for nb, out_chan in zip(num_blocks, chans):
            blocks = [RepBlock(in_chan, out_chan, 2, False, act_layer)]
            blocks.extend(RepBlock(out_chan, out_chan, 1, True, act_layer) for _ in range(nb))
            stages.append(nn.Sequential(*blocks))
            in_chan = out_chan
        super().__init__()
        self.features = nn.Sequential(*stages)
        self.head = nn.Linear(in_chan, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_(m.weight, generator=generator)
        lecun_normal_(self.head.weight, generator=generator)
        nn.init.zeros_(self.head.bias)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        x = x.mean(dim=(2, 3))  # GlobalAvgPool2d(flatten=True)
        return self.head(x)

    def reparametrize(self, s2d_stem: bool = False, s2d_input: bool = False) -> "RepVGG":
        """Folds every block into its deploy form, in place (``repvgg.py:205-239``).

        ``s2d_stem=True`` also folds the stem into its space-to-depth form
        (:meth:`RepBlock.fold_s2d`): the same logits, its conv ``(O, 12, 2, 2)``.
        ``s2d_input=True`` (implies ``s2d_stem``) makes the model take a batch already
        rearranged on the host, ``(N, 12, H/2, W/2)``
        (:func:`~holocron_tpu_torch.transforms.functional.space_to_depth_batch`).
        """
        for module in self.modules():
            if isinstance(module, RepBlock):
                module.reparametrize()
        if s2d_stem or s2d_input:
            self.features[0][0].fold_s2d(s2d_input)
        return self


def _repvgg(num_blocks: Sequence[int], a: float, b: float, pretrained: bool, checkpoint: Optional[Checkpoint],
            progress: bool, default: Optional[Checkpoint], **kwargs: Any) -> RepVGG:
    model = RepVGG(num_blocks, [64, 64, 128, 256, 512], a, b, **kwargs)
    return _pretrained(model, pretrained, checkpoint, progress, default)


class RepVGG_A0_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="repvgg_a0",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/repvgg_a0_224-d3f54b28.pth",
        acc1=0.9292,
        acc5=0.9946,
        sha256="d3f54b28567fcd7e3e32ffbcffb5bb5c64fd97b7139cba0bfe9ad0bd7765cdaa",
        size=99183419,
        num_params=24741642,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch repvgg_a0 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class RepVGG_A1_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="repvgg_a1",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/repvgg_a1_224-8d3269fb.pth",
        acc1=0.9378,
        acc5=0.9918,
        sha256="8d3269fb5181c0fe75ef617872238135f3002f41e82e5ef7492d62a402ffae50",
        size=120724868,
        num_params=30119946,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch repvgg_a1 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class RepVGG_A2_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="repvgg_a2",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/repvgg_a2_224-cb442207.pth",
        acc1=0.9363,
        acc5=0.9939,
        sha256="cb442207d0c4627e3a16d7a8b4bf5342a182fd924cf4a044ac3a832014e7d4cf",
        size=194822538,
        num_params=48629514,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch repvgg_a2 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class RepVGG_B0_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="repvgg_b0",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/repvgg_b0_224-fdcdd2b7.pth",
        acc1=0.9269,
        acc5=0.9921,
        sha256="fdcdd2b739f19b47572be5a98ec407c08935d02adf1ab0bf90d7bc92c710fe2d",
        size=127668600,
        num_params=31845642,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch repvgg_b0 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class RepVGG_B1_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="repvgg_b1",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/repvgg_b1_224-3e5b28d7.pth",
        acc1=0.9396,
        acc5=0.9939,
        sha256="3e5b28d7803965546efadeb20abb84d8fef765dd08170677467a9c06294224c4",
        size=403763795,
        num_params=100829194,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch repvgg_b1 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class RepVGG_B2_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="repvgg_b2",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/repvgg_b2_224-dc810d88.pth",
        acc1=0.9414,
        acc5=0.9957,
        sha256="dc810d889e8533f3ab24d75d8bf4cec84380abfb3b10ee01009997eab6a35d4b",
        size=630382163,
        num_params=157462410,
        commit="d4a59999179b42fc0d3058ac6b76cc41f49dd56e",
        train_args=(
            "./imagenette2-320/ --arch repvgg_b2 --batch-size 32 --grad-acc 2 --mixup-alpha 0.2 --amp --device 0"
            " --epochs 100 --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176"
            " --val-resize-size 232 --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


def repvgg_a0(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> RepVGG:
    """RepVGG-A0 (``repvgg.py:368-376``)."""
    return _repvgg([1, 2, 4, 14, 1], 0.75, 2.5, pretrained, checkpoint, progress, RepVGG_A0_Checkpoint.DEFAULT.value, **kwargs)


def repvgg_a1(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> RepVGG:
    """RepVGG-A1 (``repvgg.py:379-387``)."""
    return _repvgg([1, 2, 4, 14, 1], 1, 2.5, pretrained, checkpoint, progress, RepVGG_A1_Checkpoint.DEFAULT.value, **kwargs)


def repvgg_a2(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> RepVGG:
    """RepVGG-A2 (``repvgg.py:390-398``)."""
    return _repvgg([1, 2, 4, 14, 1], 1.5, 2.75, pretrained, checkpoint, progress, RepVGG_A2_Checkpoint.DEFAULT.value, **kwargs)


def repvgg_b0(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> RepVGG:
    """RepVGG-B0 (``repvgg.py:401-409``)."""
    return _repvgg([1, 4, 6, 16, 1], 1, 2.5, pretrained, checkpoint, progress, RepVGG_B0_Checkpoint.DEFAULT.value, **kwargs)


def repvgg_b1(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> RepVGG:
    """RepVGG-B1 (``repvgg.py:412-420``)."""
    return _repvgg([1, 4, 6, 16, 1], 2, 4, pretrained, checkpoint, progress, RepVGG_B1_Checkpoint.DEFAULT.value, **kwargs)


def repvgg_b2(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> RepVGG:
    """RepVGG-B2 (``repvgg.py:423-431``)."""
    return _repvgg([1, 4, 6, 16, 1], 2.5, 5, pretrained, checkpoint, progress, RepVGG_B2_Checkpoint.DEFAULT.value, **kwargs)


def repvgg_b3(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> RepVGG:
    """RepVGG-B3 (``repvgg.py:434-442``)."""
    return _repvgg([1, 4, 6, 16, 1], 3, 5, pretrained, checkpoint, progress, None, **kwargs)
