from . import init
from .modules import Involution2d

__all__ = ["Involution2d", "init"]
