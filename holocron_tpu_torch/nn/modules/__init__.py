from .conv import Involution2d

__all__ = ["Involution2d"]
