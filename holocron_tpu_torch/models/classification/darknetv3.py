"""Darknet-53, the YOLOv3 backbone (`Redmon & Farhadi
<https://pjreddie.com/media/files/papers/YOLOv3.pdf>`_), the port of
``holocron_tpu/models/classification/darknetv3.py``: residual blocks with an optional
DropBlock after the residual, and a forward that returns the last stages' outputs for
detection necks.

``state_dict`` keys follow original Holocron, the keys ``_convert_darknetv3``
(``holocron_tpu/models/_torch_convert.py:270-290``) reads: ``features.stem.{offset}``,
``features.layers.{i}.{offset}`` (the strided conv's block, then one :class:`ResBlock`
a block, its convs in ``conv.{offset}``) and ``classifier``.
"""

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...nn.modules.dropblock import DropBlock2d
from ..layers import BatchNorm2d
from ..utils import conv_sequence
from .darknet import init_darknet_weights, leaky_relu_01

__all__ = ["DarknetBodyV3", "DarknetV3", "ResBlock", "darknet53"]

NormLayer = Callable[[int], nn.Module]
DARKNET53_LAYOUT = [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]


class ResBlock(nn.Module):
    """A 1x1 squeeze to ``mid_planes``, a 3x3 expansion back to ``planes``, the residual
    add, then, when ``drop_layer`` is set, ``DropBlock2d(0.1, 7)`` (``darknetv3.py:27-53``)."""

    def __init__(
        self,
        planes: int,
        mid_planes: int,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
    ) -> None:
        super().__init__()
        act_layer = act_layer or leaky_relu_01()
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.conv = nn.Sequential(
            *conv_sequence(planes, mid_planes, act_layer, kernel_size=1, **common),
            *conv_sequence(mid_planes, planes, act_layer, kernel_size=3, padding=1, **common),
        )
        self.dropblock = DropBlock2d(0.1, 7) if drop_layer is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x) + x
        return out if self.dropblock is None else self.dropblock(out)


class DarknetBodyV3(nn.Module):
    """A 3x3 stem, then per stage a 3x3 stride-2 conv and ``num_blocks`` :class:`ResBlock`
    (``darknetv3.py:56-100``). With ``num_features > 1`` the forward returns the outputs
    of the last ``num_features`` stages, a list."""

    def __init__(
        self,
        layout: Sequence[Tuple[int, int]],
        in_channels: int = 3,
        stem_channels: int = 32,
        num_features: int = 1,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
    ) -> None:
        super().__init__()
        self.num_features = num_features
        act_layer = act_layer or leaky_relu_01()
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.stem = nn.Sequential(*conv_sequence(in_channels, stem_channels, act_layer, kernel_size=3, padding=1,
                                                 **common))
        layers = []
        in_planes = stem_channels
        for out_chans, num_blocks in layout:
            stage: List[nn.Module] = conv_sequence(in_planes, out_chans, act_layer, kernel_size=3, padding=1,
                                                   stride=2, **common)
            stage += [ResBlock(out_chans, out_chans // 2, act_layer, **common) for _ in range(num_blocks)]
            layers.append(nn.Sequential(*stage))
            in_planes = out_chans
        self.layers = nn.Sequential(*layers)
        self.out_channels = in_planes

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = self.stem(x)
        features = []
        for i, stage in enumerate(self.layers):
            x = stage(x)
            if i >= len(self.layers) - self.num_features:
                features.append(x)
        return x if self.num_features == 1 else features


class DarknetV3(nn.Module):
    """The Darknet-53 classifier (``darknetv3.py:103-132``): the body, global average
    pooling and a linear head.

    Weights are drawn from ``generator`` on the CPU
    (:func:`~holocron_tpu_torch.models.classification.darknet.init_darknet_weights`),
    then moved to ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``).
    """

    def __init__(
        self,
        layout: Sequence[Tuple[int, int]],
        num_classes: int = 10,
        in_channels: int = 3,
        stem_channels: int = 32,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.layout = layout
        self.features = DarknetBodyV3(layout, in_channels, stem_channels, 1, act_layer, norm_layer, drop_layer,
                                      conv_layer)
        self.classifier = nn.Linear(self.features.out_channels, num_classes)
        init_darknet_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.features(x).mean(dim=(2, 3)))


def darknet53(pretrained: bool = False, **kwargs: Any) -> DarknetV3:
    """Darknet-53 (``darknetv3.py:155-160``), 40,595,178 parameters at 10 classes."""
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    return DarknetV3(DARKNET53_LAYOUT, **kwargs)
