from . import functional, init
from .modules import *  # noqa: F403
from .modules import __all__ as _modules

__all__ = ["functional", "init", *_modules]
