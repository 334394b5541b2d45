"""Darknet-19, the YOLOv2 backbone (`Redmon & Farhadi
<https://pjreddie.com/media/files/papers/YOLO9000.pdf>`_), the port of
``holocron_tpu/models/classification/darknetv2.py``, with the ``passthrough`` forward
that also returns the second-to-last group's features.

``state_dict`` keys follow original Holocron, the keys ``convert_darknet_body_v2``
(``holocron_tpu/models/_torch_convert.py:244-256``) reads: ``features.stem.{offset}``,
``features.layers.{i}.{offset}`` (a max pool at offset 0, then the conv blocks) and the
1x1 ``classifier`` conv.
"""

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...nn.init import lecun_normal_
from ..layers import BatchNorm2d
from ..utils import conv_sequence
from .darknet import init_darknet_weights, leaky_relu_01

__all__ = ["DarknetBodyV2", "DarknetV2", "darknet19"]

NormLayer = Callable[[int], nn.Module]
DARKNET19_LAYOUT = [(64, 0), (128, 1), (256, 1), (512, 2), (1024, 2)]


class DarknetBodyV2(nn.Module):
    """A 3x3 stem, then per group a 2x2 max pool, a 3x3 conv and ``num_blocks`` pairs of
    a 1x1 conv to half the width and a 3x3 conv back (``darknetv2.py:26-61``). With
    ``passthrough`` the forward returns ``(x, aux)``, ``aux`` the output of the
    second-to-last group."""

    def __init__(
        self,
        layout: Sequence[Tuple[int, int]],
        in_channels: int = 3,
        stem_channels: int = 32,
        passthrough: bool = False,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
    ) -> None:
        super().__init__()
        self.passthrough = passthrough
        act_layer = act_layer or leaky_relu_01()
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.stem = nn.Sequential(*conv_sequence(in_channels, stem_channels, act_layer, kernel_size=3, padding=1,
                                                 **common))
        layers = []
        in_planes = stem_channels
        for out_chans, num_blocks in layout:
            group: List[nn.Module] = [nn.MaxPool2d(2)]
            group += conv_sequence(in_planes, out_chans, act_layer, kernel_size=3, padding=1, **common)
            for _ in range(num_blocks):
                group += conv_sequence(out_chans, out_chans // 2, act_layer, kernel_size=1, **common)
                group += conv_sequence(out_chans // 2, out_chans, act_layer, kernel_size=3, padding=1, **common)
            layers.append(nn.Sequential(*group))
            in_planes = out_chans
        self.layers = nn.Sequential(*layers)
        self.out_channels = in_planes

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        x = self.stem(x)
        aux = None
        for i, group in enumerate(self.layers):
            x = group(x)
            if i == len(self.layers) - 2:
                aux = x
        return (x, aux) if self.passthrough else x


class DarknetV2(nn.Module):
    """The Darknet-19 classifier (``darknetv2.py:64-100``): the body, a biased 1x1 conv
    to the classes and global average pooling.

    Weights are drawn from ``generator`` on the CPU
    (:func:`~holocron_tpu_torch.models.classification.darknet.init_darknet_weights`;
    the classifier conv LeCun normal, flax's default), then moved to ``device``: the card
    unless the caller asks for the CPU (``device="cpu"``).
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
        self.features = DarknetBodyV2(layout, in_channels, stem_channels, False, act_layer, norm_layer, drop_layer,
                                      conv_layer)
        self.classifier = nn.Conv2d(self.features.out_channels, num_classes, 1)
        init_darknet_weights(self, generator)
        with torch.no_grad():
            lecun_normal_(self.classifier.weight.view(num_classes, -1), generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.features(x)).mean(dim=(2, 3))


def darknet19(pretrained: bool = False, **kwargs: Any) -> DarknetV2:
    """Darknet-19 (``darknetv2.py:119-124``), 19,827,626 parameters at 10 classes."""
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    return DarknetV2(DARKNET19_LAYOUT, **kwargs)
