"""Optimizers and learning-rate schedules (``holocron_tpu/optim``)."""

from . import schedules
from .lamb import LAMB
from .tadam import TAdam

__all__ = ["LAMB", "TAdam", "schedules"]
