from . import checkpoints, classification, core, layers, presets, utils
from .classification import *  # noqa: F403
