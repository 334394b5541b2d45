from .repvgg import *  # noqa: F403
