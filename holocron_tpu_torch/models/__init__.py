from . import checkpoints, classification, core, detection, layers, presets, segmentation, utils
from .classification import *  # noqa: F403
