from .pyconv_resnet import *  # noqa: F403
from .repvgg import *  # noqa: F403
from .res2net import *  # noqa: F403
from .resnet import *  # noqa: F403
from .rexnet import *  # noqa: F403
from .sknet import *  # noqa: F403
from .tridentnet import *  # noqa: F403
