from .encoders import *  # noqa: F403
from .unet import *  # noqa: F403
from .unet3p import *  # noqa: F403
from .unetpp import *  # noqa: F403
