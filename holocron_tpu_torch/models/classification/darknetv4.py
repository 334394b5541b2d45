"""CSP-Darknet-53, the YOLOv4 backbone (`Wang et al. <https://arxiv.org/pdf/1911.11929.pdf>`_),
the port of ``holocron_tpu/models/classification/darknetv4.py``. Each cross-stage-partial
stage: a strided base conv, a 1x1 widening, a split of the channels into halves, residual
blocks on the second half, a concat with the first and a 1x1 transition. The mish
variant takes Mish activations and DropBlock.

``state_dict`` keys follow original Holocron, the keys ``convert_darknet_body_v4``
(``holocron_tpu/models/_torch_convert.py:302-324``) reads: ``features.stem.{offset}``,
``features.stages.{i}`` with ``base_layer``, ``main`` (the blocks, then the 1x1 conv's
layers) and ``transition``, and ``classifier``. A ``drop_layer`` adds a DropBlock after
each conv block's activation, which shifts the offsets by one a block
(``_torch_convert.py:291-295``).
"""

from enum import Enum
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...nn.modules.dropblock import DropBlock2d
from ..layers import BatchNorm2d
from ..checkpoints import Checkpoint
from ..utils import _checkpoint, _pretrained, conv_sequence
from .darknet import init_darknet_weights
from .darknetv3 import ResBlock

__all__ = ["CSPDarknet53_Checkpoint", "CSPDarknet53_Mish_Checkpoint", "CSPStage", "DarknetBodyV4", "DarknetV4",
           "cspdarknet53", "cspdarknet53_mish"]

NormLayer = Callable[[int], nn.Module]
CSPDARKNET53_LAYOUT = [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]


def _leaky_relu() -> nn.Module:
    """``jax.nn.leaky_relu``: slope 0.01."""
    return nn.LeakyReLU(0.01, inplace=True)


class CSPStage(nn.Module):
    """A cross-stage-partial stage (``darknetv4.py:26-67``). With one block the halves
    are ``out_channels`` wide and the block squeezes to the stage's ``in_channels``;
    with more, both are ``out_channels // 2``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_blocks: int = 1,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
    ) -> None:
        super().__init__()
        act_layer = act_layer or _leaky_relu()
        compression = 2 if num_blocks > 1 else 1
        half = out_channels // compression
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.base_layer = nn.Sequential(
            *conv_sequence(in_channels, out_channels, act_layer, kernel_size=3, padding=1, stride=2, **common),
            *conv_sequence(out_channels, 2 * half, act_layer, kernel_size=1, **common),
        )
        mid = half if num_blocks > 1 else in_channels
        self.main = nn.Sequential(
            *(ResBlock(half, mid, act_layer, **common) for _ in range(num_blocks)),
            *conv_sequence(half, half, act_layer, kernel_size=1, **common),
        )
        self.transition = nn.Sequential(*conv_sequence(2 * half, out_channels, act_layer, kernel_size=1, **common))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.base_layer(x).chunk(2, dim=1)
        return self.transition(torch.cat([x1, self.main(x2)], dim=1))


class DarknetBodyV4(nn.Module):
    """A 3x3 stem, then :class:`CSPStage` stages (``darknetv4.py:70-110``). With
    ``num_features > 1`` the forward returns the outputs of the last ``num_features``
    stages, a list."""

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
        act_layer = act_layer or _leaky_relu()
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.stem = nn.Sequential(*conv_sequence(in_channels, stem_channels, act_layer, kernel_size=3, padding=1,
                                                 **common))
        stages = []
        in_planes = stem_channels
        for out_chans, num_blocks in layout:
            stages.append(CSPStage(in_planes, out_chans, num_blocks, act_layer, **common))
            in_planes = out_chans
        self.stages = nn.Sequential(*stages)
        self.out_channels = in_planes

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = self.stem(x)
        features = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i >= len(self.stages) - self.num_features:
                features.append(x)
        return x if self.num_features == 1 else features


class DarknetV4(nn.Module):
    """The CSP-Darknet-53 classifier (``darknetv4.py:113-146``): the body, global
    average pooling and a linear head.

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
        self.layout, self.drop_layer = layout, drop_layer
        self.features = DarknetBodyV4(layout, in_channels, stem_channels, 1, act_layer, norm_layer, drop_layer,
                                      conv_layer)
        self.classifier = nn.Linear(self.features.out_channels, num_classes)
        init_darknet_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.features(x).mean(dim=(2, 3)))


class CSPDarknet53_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="cspdarknet53",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/cspdarknet53_224-7a69463a.pth",
        acc1=0.9450,
        acc5=0.9964,
        sha256="7a69463a4bd445beb6691dfd6ef7378efcf941f75d07d60034106ebedfcb82f8",
        size=106732575,
        num_params=26627434,
        commit="6e32c5b578711a2ef3731a8f8c61760ed9f03e58",
        train_args=(
            "./imagenette2-320/ --arch cspdarknet53 --batch-size 64 --mixup-alpha 0.2 --amp --device 0 --epochs 100"
            " --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176 --val-resize-size 232"
            " --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


class CSPDarknet53_Mish_Checkpoint(Enum):
    IMAGENETTE = _checkpoint(
        arch="cspdarknet53_mish",
        url="https://github.com/frgfm/Holocron/releases/download/v0.2.1/cspdarknet53_mish_224-1b660b3c.pth",
        acc1=0.9465,
        acc5=0.9969,
        sha256="1b660b3cb144195100c99ee3b9b863c37a5b5a59619c8de8c588b3d2af954b15",
        size=106737530,
        num_params=26627434,
        commit="6e32c5b578711a2ef3731a8f8c61760ed9f03e58",
        train_args=(
            "./imagenette2-320/ --arch cspdarknet53_mish --batch-size 32 --grad-acc 2 --mixup-alpha 0.2 --amp"
            "  --device 0 --epochs 100 --lr 1e-3 --label-smoothing 0.1 --random-erase 0.1 --train-crop-size 176"
            " --val-resize-size 232 --opt adamw --weight-decay 5e-2"
        ),
    )
    DEFAULT = IMAGENETTE


def cspdarknet53(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
                 **kwargs: Any) -> DarknetV4:
    """CSP-Darknet-53 (``darknetv4.py:187-192``), 26,627,434 parameters at 10 classes."""
    return _pretrained(DarknetV4(CSPDARKNET53_LAYOUT, **kwargs), pretrained, checkpoint, progress,
                       CSPDarknet53_Checkpoint.DEFAULT.value)


def cspdarknet53_mish(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
                      **kwargs: Any) -> DarknetV4:
    """CSP-Darknet-53 with Mish and DropBlock (``darknetv4.py:195-202``)."""
    kwargs["act_layer"] = nn.Mish()
    kwargs["drop_layer"] = DropBlock2d
    return _pretrained(DarknetV4(CSPDARKNET53_LAYOUT, **kwargs), pretrained, checkpoint, progress,
                       CSPDarknet53_Mish_Checkpoint.DEFAULT.value)
