"""Structured dropout (``holocron_tpu/nn/modules/dropblock.py``), on NCHW tensors."""

from typing import Optional

import torch
from torch import nn

from .. import functional as HF

__all__ = ["DropBlock2d"]


class DropBlock2d(nn.Module):
    """DropBlock (`Ghiasi et al. <https://arxiv.org/pdf/1810.12890.pdf>`_,
    ``dropblock.py:14-33``), in train mode only.

    ``p`` is the probability of dropping an activation. As original Holocron and the
    JAX package, the module passes ``p / block_size**2`` to the functional, which
    divides by ``block_size**2`` again: block centers are drawn at ``p /
    block_size**4``. The draw comes from ``generator`` (None: torch's default one),
    which must lie on the input's device. A factory ``lambda: DropBlock2d(...)`` is a
    ``drop_layer`` of :func:`~holocron_tpu_torch.models.utils.conv_sequence`.
    """

    def __init__(self, p: float = 0.1, block_size: int = 7, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.p, self.block_size, self.generator = p, block_size, generator

    @property
    def drop_prob(self) -> float:
        return self.p / self.block_size**2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        out = HF.dropblock2d(x.permute(0, 2, 3, 1), self.drop_prob, self.block_size, True, self.generator)
        return out.permute(0, 3, 1, 2)
