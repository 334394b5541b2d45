from .conv import Add2d, Involution2d

__all__ = ["Add2d", "Involution2d"]
