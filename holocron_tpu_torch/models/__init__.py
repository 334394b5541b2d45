from . import checkpoints, classification, core, detection, layers, presets, utils
from .classification import *  # noqa: F403
