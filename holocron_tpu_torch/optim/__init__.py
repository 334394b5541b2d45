"""Optimizers and learning-rate schedules (``holocron_tpu/optim``)."""

from . import schedules
from .lamb import LAMB

__all__ = ["LAMB", "schedules"]
