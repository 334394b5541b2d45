"""Optimizers and learning-rate schedules (``holocron_tpu/optim``). ``AdamW`` and ``RAdam``
are ``torch.optim``'s, taking a schedule as the port's own optimizers do (the
segmentation reference's ``adamw`` and ``radam``: optax's ``adamw`` and ``radam``
after ``add_decayed_weights``, whose decay torch's ``RAdam`` couples the same way)."""

import torch

from . import schedules
from ._common import scheduled
from .adabelief import AdaBelief
from .adamp import AdamP
from .lamb import LAMB
from .tadam import TAdam

AdamW = scheduled(torch.optim.AdamW)
RAdam = scheduled(torch.optim.RAdam)

__all__ = ["AdaBelief", "AdamP", "AdamW", "LAMB", "RAdam", "TAdam", "scheduled", "schedules"]
