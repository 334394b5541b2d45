"""PyConvResNet and PyConvHGResNet (`Duta et al. <https://arxiv.org/pdf/2006.11538.pdf>`_),
the port of ``holocron_tpu/models/classification/pyconv_resnet.py``: bottlenecks whose
middle conv is a :class:`~holocron_tpu_torch.nn.PyConv2d` pyramid, in the
:class:`~.resnet.ResNet` container without the stem's max pool, with a group schedule
a stage."""

from typing import Any, Callable, Optional, Sequence

from torch import nn

from ...nn.modules.conv import PyConv2d
from ..layers import BatchNorm2d
from ..utils import conv_sequence
from .resnet import NormLayer, ResNet, _ResBlock, _relu, _resnet

__all__ = ["PyBottleneck", "PyHGBottleneck", "pyconv_resnet50", "pyconvhg_resnet50"]


class PyBottleneck(_ResBlock):
    """Bottleneck with a pyramidal middle conv (``pyconv_resnet.py:27-98``): 1x1 to
    ``int(planes * base_width / 64) * min(groups)`` channels, a ``num_levels``-level
    :class:`PyConv2d` with one group count a level (key ``conv.3.{level}``) and its norm
    and act, 1x1 to ``planes * expansion``."""

    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        downsample: bool = False,
        groups: Optional[Sequence[int]] = None,
        base_width: int = 64,
        dilation: int = 1,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        avg_downsample: bool = False,
        zero_init_residual: bool = False,
        num_levels: int = 2,
    ) -> None:
        act_layer = act_layer or _relu()
        norm_layer = norm_layer or BatchNorm2d
        groups = list(groups) if groups is not None else [1]
        width = int(planes * (base_width / 64.0)) * min(groups)
        out_channels = planes * self.expansion

        def pyconv(in_channels, out_channels, kernel_size, stride, padding, dilation, groups, bias):
            # the JAX package's factory drops the dilation (pyconv_resnet.py:61-73)
            return PyConv2d(in_channels, out_channels, kernel_size, num_levels, padding, groups, bias, stride,
                            device="cpu")

        layers = [
            *conv_sequence(inplanes, width, act_layer, norm_layer, drop_layer, kernel_size=1),
            *conv_sequence(width, width, act_layer, norm_layer, drop_layer, pyconv, kernel_size=3, stride=stride,
                           padding=dilation, dilation=dilation, groups=groups),
            *conv_sequence(width, out_channels, None, norm_layer, drop_layer, kernel_size=1),
        ]
        super().__init__(layers, inplanes, out_channels, stride, downsample, avg_downsample, act_layer, norm_layer)


class PyHGBottleneck(PyBottleneck):
    """The higher-capacity variant, with expansion 2 (``pyconv_resnet.py:101-104``)."""

    expansion = 2


def _pyconvresnet(block, planes, width_per_group: int, groups, pretrained: bool, **kwargs: Any) -> ResNet:
    return _resnet(block, [3, 4, 6, 3], planes, pretrained, stem_pool=False, width_per_group=width_per_group,
                   block_args=[{"num_levels": len(g), "groups": tuple(g)} for g in groups], **kwargs)


def pyconv_resnet50(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """PyConvResNet-50 (``pyconv_resnet.py:135-147``)."""
    return _pyconvresnet(PyBottleneck, [64, 128, 256, 512], 64, [[1, 4, 8, 16], [1, 4, 8], [1, 4], [1]],
                         pretrained, **kwargs)


def pyconvhg_resnet50(pretrained: bool = False, **kwargs: Any) -> ResNet:
    """PyConvHGResNet-50 (``pyconv_resnet.py:150-162``)."""
    return _pyconvresnet(PyHGBottleneck, [128, 256, 512, 1024], 2, [[32, 32, 32, 32], [32, 64, 64], [32, 64], [32]],
                         pretrained, **kwargs)
