from . import checkpoints, classification, core, detection, layers, presets, segmentation, utils
from .checkpoints import *  # noqa: F403
from .classification import *  # noqa: F403
from .detection import *  # noqa: F403
from .segmentation import *  # noqa: F403
from .utils import ConvSequence, conv_sequence, fuse_conv_bn, load_pretrained_params, model_from_hf_hub
