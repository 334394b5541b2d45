from . import classification, layers, utils
from .classification import *  # noqa: F403
