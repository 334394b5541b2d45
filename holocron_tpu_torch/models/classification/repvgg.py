"""RepVGG (`Ding et al. <https://arxiv.org/pdf/2101.03697.pdf>`_), the port of
``holocron_tpu/models/classification/repvgg.py``.

Train form: per block, the sum of a 3x3 conv+BN branch, a 1x1 conv+BN branch and, for
stride-1 same-width blocks, an identity BN branch, then the activation.
:meth:`RepVGG.reparametrize` folds every block in place into one biased 3x3 conv, as
original Holocron does. ``state_dict`` keys follow original Holocron:
``features.{s}.{j}.branches.{0,1,2}`` in train form, ``features.{s}.{j}.branches``
(a biased conv) in deploy form, and ``head.*``.
"""

from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from ...nn.init import kaiming_normal_, lecun_normal_
from ..layers import BatchNorm2d
from ..utils import fuse_conv_bn

__all__ = [
    "RepBlock",
    "RepVGG",
    "repvgg_a0",
    "repvgg_a1",
    "repvgg_a2",
    "repvgg_b0",
    "repvgg_b1",
    "repvgg_b2",
    "repvgg_b3",
]


class RepBlock(nn.Module):
    """One RepVGG block (``repvgg.py:43-114``)."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(self.branches, nn.ModuleList):  # deploy form: one conv (float or int8)
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

    def reparametrize(self) -> "RepVGG":
        """Folds every block into its deploy form, in place (``repvgg.py:205-239``)."""
        for module in self.modules():
            if isinstance(module, RepBlock):
                module.reparametrize()
        return self


def _repvgg(num_blocks: Sequence[int], a: float, b: float, pretrained: bool, **kwargs: Any) -> RepVGG:
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    return RepVGG(num_blocks, [64, 64, 128, 256, 512], a, b, **kwargs)


def repvgg_a0(pretrained: bool = False, **kwargs: Any) -> RepVGG:
    """RepVGG-A0 (``repvgg.py:368-376``)."""
    return _repvgg([1, 2, 4, 14, 1], 0.75, 2.5, pretrained, **kwargs)


def repvgg_a1(pretrained: bool = False, **kwargs: Any) -> RepVGG:
    """RepVGG-A1 (``repvgg.py:379-387``)."""
    return _repvgg([1, 2, 4, 14, 1], 1, 2.5, pretrained, **kwargs)


def repvgg_a2(pretrained: bool = False, **kwargs: Any) -> RepVGG:
    """RepVGG-A2 (``repvgg.py:390-398``)."""
    return _repvgg([1, 2, 4, 14, 1], 1.5, 2.75, pretrained, **kwargs)


def repvgg_b0(pretrained: bool = False, **kwargs: Any) -> RepVGG:
    """RepVGG-B0 (``repvgg.py:401-409``)."""
    return _repvgg([1, 4, 6, 16, 1], 1, 2.5, pretrained, **kwargs)


def repvgg_b1(pretrained: bool = False, **kwargs: Any) -> RepVGG:
    """RepVGG-B1 (``repvgg.py:412-420``)."""
    return _repvgg([1, 4, 6, 16, 1], 2, 4, pretrained, **kwargs)


def repvgg_b2(pretrained: bool = False, **kwargs: Any) -> RepVGG:
    """RepVGG-B2 (``repvgg.py:423-431``)."""
    return _repvgg([1, 4, 6, 16, 1], 2.5, 5, pretrained, **kwargs)


def repvgg_b3(pretrained: bool = False, **kwargs: Any) -> RepVGG:
    """RepVGG-B3 (``repvgg.py:434-442``)."""
    return _repvgg([1, 4, 6, 16, 1], 3, 5, pretrained, **kwargs)
