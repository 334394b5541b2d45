"""ConvNeXt (`Liu et al. <https://arxiv.org/pdf/2201.03545.pdf>`_), atto to xl, the port
of ``holocron_tpu/models/classification/convnext.py``.

Blocks: a 7x7 depthwise conv, LayerNorm over the channels, a 1x1 conv to four times the
width, exact-erf GELU, a 1x1 conv back, LayerScale and stochastic depth, added to the
input. A 4x4 stride-4 stem with LayerNorm; LayerNorm and a 2x2 stride-2 conv between
stages; global average pooling, LayerNorm and a linear head. ``state_dict`` keys follow
original Holocron: ``features.0`` / ``.1`` the stem's conv and norm,
``features.{2 + s}.{j}.conv.{0,1,2,4,5}`` a block's depthwise conv, norm, 1x1 convs and
LayerScale, ``features.{2 + s}.{n}.{0,1}`` a stage's closing norm and downsampling conv,
``head.0`` / ``head.1`` the head's norm and linear layer.
"""

from typing import Any, Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["Bottlenext", "ConvNeXt", "LayerNorm2d", "LayerScale", "StochasticDepth", "convnext_atto",
           "convnext_base", "convnext_femto", "convnext_large", "convnext_nano", "convnext_pico", "convnext_small",
           "convnext_tiny", "convnext_xl", "stochastic_depth"]


def stochastic_depth(x: torch.Tensor, p: float, training: bool,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Row-mode stochastic depth (``convnext.py:39-46``, torchvision's ``StochasticDepth``):
    in training, each sample's row is kept with probability ``1 - p`` (drawn from
    ``generator``, on ``x``'s device) and scaled by ``1 / (1 - p)``, or zeroed."""
    if not training or p == 0.0:
        return x
    survival = 1.0 - p
    mask = torch.empty((x.shape[0],) + (1,) * (x.ndim - 1), dtype=x.dtype, device=x.device)
    mask.bernoulli_(survival, generator=generator)
    return x * mask / survival


class StochasticDepth(nn.Module):
    """:func:`stochastic_depth` as a module; ``generator`` (None: torch's default one for
    the device) may be set to fix the draws."""

    def __init__(self, p: float) -> None:
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stochastic_depth(x, self.p, self.training, self.generator)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (the JAX package's ``nn.LayerNorm``
    on NHWC). On a channels-last tensor the NHWC view is contiguous, so no copy is
    made."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape, self.weight, self.bias,
                            self.eps).permute(0, 3, 1, 2)


class LayerScale(nn.Module):
    """A learnable per-channel scale, initialized at ``scale`` (``convnext.py:49-57``)."""

    def __init__(self, channels: int, scale: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.reshape(-1, 1, 1)


class Bottlenext(nn.Module):
    """The ConvNeXt block (``convnext.py:60-98``)."""

    def __init__(self, inplanes: int, chan_expansion: int = 4, stochastic_depth_prob: float = 0.1,
                 layer_scale: float = 1e-6) -> None:
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(inplanes, inplanes, 7, padding=3, groups=inplanes, bias=True),
            LayerNorm2d(inplanes, eps=1e-6),
            nn.Conv2d(inplanes, inplanes * chan_expansion, 1, bias=True),
            nn.GELU(),
            nn.Conv2d(inplanes * chan_expansion, inplanes, 1, bias=True),
            LayerScale(inplanes, layer_scale),
        )
        self.stochastic_depth = StochasticDepth(stochastic_depth_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.stochastic_depth(self.conv(x))


class ConvNeXt(nn.Module):
    """The ConvNeXt body (``convnext.py:101-153``). Block ``j`` of stage ``s`` drops its
    branch with probability ``stochastic_depth_prob * (block_idx + j) / (tot_blocks - 1)``
    (``:131``), ``block_idx`` the blocks of the stages before.

    Weights are drawn from ``generator`` on the CPU (convs and the head: a normal of
    std 0.02 truncated at two std, zero bias, as the JAX package's ``trunc_normal_02``;
    norms: ones and zeros; LayerScale: 1e-6), then moved to ``device``: the card unless
    the caller asks for the CPU (``device="cpu"``).
    """

    def __init__(
        self,
        num_blocks: Sequence[int],
        planes: Sequence[int],
        num_classes: int = 10,
        in_channels: int = 3,
        stochastic_depth_prob: float = 0.0,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_blocks, self.planes = list(num_blocks), list(planes)
        layers = [nn.Conv2d(in_channels, planes[0], 4, 4, bias=True), LayerNorm2d(planes[0], eps=1e-6)]
        block_idx, tot_blocks = 0, sum(num_blocks)
        out_planes = list(planes[1:]) + [planes[-1]]
        for nb, chans, out_chans in zip(num_blocks, planes, out_planes):
            stage = [Bottlenext(chans, stochastic_depth_prob=stochastic_depth_prob * (block_idx + j) / (tot_blocks - 1.0))
                     for j in range(nb)]
            if chans != out_chans:
                stage.append(nn.Sequential(LayerNorm2d(chans, eps=1e-6), nn.Conv2d(chans, out_chans, 2, 2, bias=True)))
            layers.append(nn.Sequential(*stage))
            block_idx += nb
        self.features = nn.Sequential(*layers)
        self.head = nn.Sequential(nn.LayerNorm(planes[-1], eps=1e-6), nn.Linear(planes[-1], num_classes))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    nn.init.trunc_normal_(m.weight, 0.0, 0.02, -0.04, 0.04, generator=generator)
                    nn.init.zeros_(m.bias)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x).mean(dim=(2, 3)))


def _convnext(num_blocks: Sequence[int], planes: Sequence[int], pretrained: bool, **kwargs: Any) -> ConvNeXt:
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    return ConvNeXt(num_blocks, planes, **kwargs)


def convnext_atto(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-Atto (``convnext.py:179-182``)."""
    return _convnext([2, 2, 6, 2], [40, 80, 160, 320], pretrained, **kwargs)


def convnext_femto(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-Femto (``convnext.py:185-188``)."""
    return _convnext([2, 2, 6, 2], [48, 96, 192, 384], pretrained, **kwargs)


def convnext_pico(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-Pico (``convnext.py:191-194``)."""
    return _convnext([2, 2, 6, 2], [64, 128, 256, 512], pretrained, **kwargs)


def convnext_nano(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-Nano (``convnext.py:197-200``)."""
    return _convnext([2, 2, 8, 2], [80, 160, 320, 640], pretrained, **kwargs)


def convnext_tiny(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-T (``convnext.py:203-206``)."""
    return _convnext([3, 3, 9, 3], [96, 192, 384, 768], pretrained, **kwargs)


def convnext_small(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-S (``convnext.py:209-212``)."""
    return _convnext([3, 3, 27, 3], [96, 192, 384, 768], pretrained, **kwargs)


def convnext_base(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-B (``convnext.py:215-218``)."""
    return _convnext([3, 3, 27, 3], [128, 256, 512, 1024], pretrained, **kwargs)


def convnext_large(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-L (``convnext.py:221-224``)."""
    return _convnext([3, 3, 27, 3], [192, 384, 768, 1536], pretrained, **kwargs)


def convnext_xl(pretrained: bool = False, **kwargs: Any) -> ConvNeXt:
    """ConvNeXt-XL (``convnext.py:227-230``)."""
    return _convnext([3, 3, 27, 3], [256, 512, 1024, 2048], pretrained, **kwargs)
