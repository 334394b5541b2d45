from . import classification

__all__ = ["classification"]
