from .conv import Add2d, Involution2d, PyConv2d
from .downsample import BlurPool2d, GlobalAvgPool2d

__all__ = ["Add2d", "BlurPool2d", "GlobalAvgPool2d", "Involution2d", "PyConv2d"]
