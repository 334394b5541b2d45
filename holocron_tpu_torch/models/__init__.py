from . import checkpoints, classification, layers, presets, utils
from .classification import *  # noqa: F403
