from . import functional, init
from .modules import Add2d, BlurPool2d, GlobalAvgPool2d, Involution2d, PyConv2d

__all__ = ["Add2d", "BlurPool2d", "GlobalAvgPool2d", "Involution2d", "PyConv2d", "functional", "init"]
