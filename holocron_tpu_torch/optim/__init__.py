"""Optimizers and learning-rate schedules (``holocron_tpu/optim``). ``AdamW`` and ``RAdam``
are ``torch.optim``'s, taking a schedule as the port's own optimizers do (the
segmentation reference's ``adamw`` and ``radam``: optax's ``adamw`` and ``radam``
after ``add_decayed_weights``, whose decay torch's ``RAdam`` couples the same way).
``SGD`` and ``Adam`` are ``torch.optim``'s too, for the classification reference's
``sgd`` and ``adam``. ``Lookahead`` and ``Scout`` wrap a built optimizer."""

import torch

from . import schedules
from ._common import scheduled
from .adabelief import AdaBelief
from .adamp import AdamP
from .adan import Adan
from .ademamix import AdEMAMix
from .lamb import LAMB
from .lars import LARS
from .ralars import RaLars
from .tadam import TAdam
from .wrapper import Lookahead, Scout

Adam = scheduled(torch.optim.Adam)
AdamW = scheduled(torch.optim.AdamW)
RAdam = scheduled(torch.optim.RAdam)
SGD = scheduled(torch.optim.SGD)

__all__ = ["AdEMAMix", "AdaBelief", "Adam", "AdamP", "AdamW", "Adan", "LAMB", "LARS", "Lookahead", "RAdam", "RaLars",
           "SGD", "Scout", "TAdam", "scheduled", "schedules"]
