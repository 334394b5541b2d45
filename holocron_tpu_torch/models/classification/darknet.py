"""Darknet-24, the YOLOv1 backbone (`Redmon et al.
<https://pjreddie.com/media/files/papers/yolo_1.pdf>`_), the port of
``holocron_tpu/models/classification/darknet.py``.

No norm layers by default (the convs carry biases), LeakyReLU at slope 0.1.
``state_dict`` keys follow original Holocron, the keys ``_convert_darknetv1``
(``holocron_tpu/models/_torch_convert.py:394-413``) reads: ``features.stem.{offset}``,
``features.layers.{i}.{offset}`` (a max pool at offset 0, then each conv's
:func:`~holocron_tpu_torch.models.utils.conv_sequence` layers) and ``classifier``.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ...nn.init import kaiming_normal_, lecun_normal_
from ..checkpoints import Checkpoint
from ..presets import IMAGENETTE
from ..utils import _pretrained, conv_sequence

__all__ = ["DarknetBodyV1", "DarknetV1", "darknet24"]

NormLayer = Callable[[int], nn.Module]
# darknet.py:22-29, the input shape channel-first
default_cfgs: Dict[str, Dict[str, Any]] = {
    "darknet24": {
        **IMAGENETTE.__dict__,
        "input_shape": (3, 224, 224),
        "url": "https://github.com/frgfm/Holocron/releases/download/v0.1.3/darknet24_224-816d72cb.pt",
    },
}
DARKNET24_LAYOUT = [[192], [128, 256, 256, 512], [*([256, 512] * 4), 512, 1024], [512, 1024] * 2]


def leaky_relu_01() -> nn.Module:
    """LeakyReLU at slope 0.1 (``darknet.py:30``), not torch's default of 0.01."""
    return nn.LeakyReLU(0.1, inplace=True)


class DarknetBodyV1(nn.Module):
    """A 7x7 stride-2 stem, then per group a 2x2 max pool and convs alternating 3x3 (where
    the width grows) and 1x1 (``darknet.py:33-69``)."""

    def __init__(
        self,
        layout: Sequence[Sequence[int]],
        in_channels: int = 3,
        stem_channels: int = 64,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
    ) -> None:
        super().__init__()
        act_layer = act_layer or leaky_relu_01()
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.stem = nn.Sequential(*conv_sequence(in_channels, stem_channels, act_layer, kernel_size=7, padding=3,
                                                 stride=2, **common))
        layers = []
        in_planes = stem_channels
        for planes in layout:
            group: List[nn.Module] = [nn.MaxPool2d(2)]
            for out_planes in planes:
                k = 3 if out_planes > in_planes else 1
                group += conv_sequence(in_planes, out_planes, act_layer, kernel_size=k, padding=k // 2, **common)
                in_planes = out_planes
            layers.append(nn.Sequential(*group))
        self.layers = nn.Sequential(*layers)
        self.out_channels = in_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(self.stem(x))


class DarknetV1(nn.Module):
    """The Darknet-24 classifier (``darknet.py:72-100``): the body, global average
    pooling and a linear head.

    Weights are drawn from ``generator`` on the CPU (:func:`init_darknet_weights`), then
    moved to ``device``: the card unless the caller asks for the CPU (``device="cpu"``).
    """

    def __init__(
        self,
        layout: Sequence[Sequence[int]],
        num_classes: int = 10,
        in_channels: int = 3,
        stem_channels: int = 64,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.layout, self.norm_layer = layout, norm_layer
        self.features = DarknetBodyV1(layout, in_channels, stem_channels, act_layer, norm_layer, drop_layer,
                                      conv_layer)
        self.classifier = nn.Linear(self.features.out_channels, num_classes)
        init_darknet_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.features(x).mean(dim=(2, 3)))


@torch.no_grad()
def init_darknet_weights(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """The JAX package's initializers, in module order, from ``generator``: convs
    fan-out He-normal with zero biases (``ConvSequence``,
    ``holocron_tpu/models/utils.py:110``), linear layers LeCun normal with zero biases
    (flax's ``nn.Dense``); norms ones and zeros."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            kaiming_normal_(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def darknet24(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
              **kwargs: Any) -> DarknetV1:
    """Darknet-24 (``darknet.py:110-118``), 22,413,386 parameters at 10 classes."""
    return _pretrained(DarknetV1(DARKNET24_LAYOUT, **kwargs), pretrained, checkpoint, progress,
                       default_cfgs["darknet24"])
