"""Feature-pyramid encoders of DynamicUNet, the port of
``holocron_tpu/models/segmentation/encoders.py``, on the classification zoo's blocks.

Each is a :class:`~holocron_tpu_torch.models.segmentation.unet.FeaturePyramid`: a
``Sequential`` of the backbone's layers in the classifier's key order (so its keys
read as ``encoder.{i}...`` inside DynamicUNet, as original Holocron's
``IntermediateLayerGetter`` gives them) that returns the outputs of its tap layers.
"""

from math import ceil
from typing import List, Optional, Sequence

from torch import nn

from ..classification.resnet import BasicBlock
from ..classification.rexnet import ReXBlock
from ..layers import BatchNorm2d
from ..utils import conv_sequence
from .unet import FeaturePyramid

__all__ = ["ReXNetFeatures", "ResNet34Features"]


class ResNet34Features(FeaturePyramid):
    """The ResNet-34 pyramid (``encoders.py:23-55``): the 7x7
    stride-2 stem after its activation (``encoder.2``), then the output of each of the
    four stages of :class:`BasicBlock` (``encoder.4`` to ``encoder.7``, after the 3x3
    max pool at ``encoder.3``)."""

    def __init__(self, in_channels: int = 3, act_layer: Optional[nn.Module] = None) -> None:
        act_layer = act_layer or nn.ReLU(inplace=True)
        layers: List[nn.Module] = conv_sequence(in_channels, 64, act_layer, BatchNorm2d, kernel_size=7, stride=2,
                                                padding=3)
        layers.append(nn.MaxPool2d(3, 2, 1))
        in_planes = 64
        for i, (nb, planes) in enumerate(zip([3, 4, 6, 3], [64, 128, 256, 512])):
            stride = 1 if i == 0 else 2
            layers.append(nn.Sequential(*(
                BasicBlock(in_planes if j == 0 else planes, planes, stride if j == 0 else 1,
                           downsample=j == 0 and (stride != 1 or in_planes != planes), act_layer=act_layer)
                for j in range(nb))))
            in_planes = planes
        super().__init__(layers, [2, 4, 5, 6, 7])


class ReXNetFeatures(FeaturePyramid):
    """The ReXNet pyramid (``encoders.py:58-99``): the SiLU stride-2 stem (``encoder.0``
    to ``.2``) and the :class:`ReXBlock` s of :class:`~holocron_tpu_torch.models.ReXNet`
    (``encoder.{3 + i}``), the outputs of the blocks in ``out_blocks`` returned; no
    penultimate conv."""

    def __init__(self, width_mult: float = 1.3, depth_mult: float = 1.0, out_blocks: Sequence[int] = (0, 2, 4, 10, 15),
                 in_channels: int = 3, in_planes: int = 16, final_planes: int = 180, use_se: bool = True,
                 se_ratio: int = 12, act_layer: Optional[nn.Module] = None) -> None:
        act_layer = act_layer or nn.SiLU(inplace=True)
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

        layers: List[nn.Module] = conv_sequence(in_channels, chans[0], act_layer, BatchNorm2d, kernel_size=3,
                                                stride=2, padding=1)
        t = 1
        for c_in, c, s, se in zip(chans[:-1], chans[1:], strides, ses):
            layers.append(ReXBlock(c_in, c, t, s, se, se_ratio))
            t = 6
        super().__init__(layers, [3 + i for i in out_blocks])
