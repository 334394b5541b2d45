"""Host-side utilities (``holocron_tpu/utils``): the reference CLIs' datasets and the
native JPEG decoder the service uses."""

from . import data

__all__ = ["data"]
