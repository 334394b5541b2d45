"""Host-side utilities (``holocron_tpu/utils``): so far the native JPEG decoder the
service uses."""

from . import data

__all__ = ["data"]
