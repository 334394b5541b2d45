from . import functional, init
from .modules import Add2d, Involution2d

__all__ = ["Add2d", "Involution2d", "functional", "init"]
