"""Loss modules (``holocron_tpu/nn/modules/loss.py``) around the functions of
:mod:`holocron_tpu_torch.nn.functional`, on channel-last logits as those take them.

Each holds its class weights as a buffer, moved to ``device`` (the card unless the
caller asks for the CPU), so that ``.to()`` carries them with the model.
"""

from typing import Any, List, Optional, Union

import torch
from torch import nn

from .. import functional as HF

__all__ = [
    "ClassBalancedWrapper",
    "ComplementCrossEntropy",
    "DiceLoss",
    "FocalLoss",
    "MultiLabelCrossEntropy",
    "MutualChannelLoss",
    "PolyLoss",
]

Weight = Optional[Union[float, List[float], torch.Tensor]]
Device = Union[str, torch.device]


class _Loss(nn.Module):
    """Weight, ``ignore_index`` and reduction (``loss.py:28-48``): a float weight ``w``
    stands for the two classes' ``[w, 1 - w]``, a list for one weight a class."""

    def __init__(self, weight: Weight = None, ignore_index: int = -100, reduction: str = "mean",
                 device: Device = torch.device("cuda")) -> None:
        super().__init__()
        if isinstance(weight, (float, int)) and not isinstance(weight, bool):
            weight = torch.tensor([weight, 1 - weight], dtype=torch.float32)
        elif isinstance(weight, (list, tuple)):
            weight = torch.tensor(weight, dtype=torch.float32)
        self.register_buffer("weight", weight)
        self.ignore_index = ignore_index
        if reduction not in ("none", "mean", "sum"):
            raise NotImplementedError("argument reduction received an incorrect input")
        self.reduction = reduction
        self.to(device)


class FocalLoss(_Loss):
    """Focal loss criterion (``loss.py:51-62``)."""

    def __init__(self, gamma: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.gamma = gamma

    def forward(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return HF.focal_loss(x, target, self.weight, self.ignore_index, self.reduction, self.gamma)

    def extra_repr(self) -> str:
        return f"gamma={self.gamma}, reduction='{self.reduction}'"


class MultiLabelCrossEntropy(_Loss):
    """Cross-entropy with dense targets (``loss.py:65-72``)."""

    def forward(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return HF.multilabel_cross_entropy(x, target, self.weight, self.ignore_index, self.reduction)

    def extra_repr(self) -> str:
        return f"reduction='{self.reduction}'"


class ComplementCrossEntropy(_Loss):
    """Complement cross-entropy criterion (``loss.py:75-86``)."""

    def __init__(self, gamma: float = -1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.gamma = gamma

    def forward(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return HF.complement_cross_entropy(x, target, self.weight, self.ignore_index, self.reduction, self.gamma)

    def extra_repr(self) -> str:
        return f"gamma={self.gamma}, reduction='{self.reduction}'"


class ClassBalancedWrapper(nn.Module):
    """Class-balanced reweighting (`Cui et al. <https://arxiv.org/pdf/1901.05555.pdf>`_,
    ``loss.py:89-109``): scales the wrapped criterion's class weights by ``(1 - beta) /
    (1 - beta^n)``, or sets them to it where it has none; the weights go to ``device``."""

    def __init__(self, criterion: _Loss, num_samples: Union[List[int], torch.Tensor], beta: float = 0.99,
                 device: Device = torch.device("cuda")) -> None:
        super().__init__()
        self.criterion, self.beta = criterion, beta
        cb_weights = (1 - beta) / (1 - beta ** torch.as_tensor(num_samples, dtype=torch.float32))
        cb_weights = cb_weights.to(device)
        criterion.weight = cb_weights if criterion.weight is None else criterion.weight.to(device) * cb_weights

    def forward(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return self.criterion(x, target)

    def extra_repr(self) -> str:
        return f"beta={self.beta}"


class MutualChannelLoss(_Loss):
    """Mutual channel loss criterion (``loss.py:112-139``). The channel masks are drawn
    from ``generator`` (on the input's device); without one, from a generator seeded
    with 0 at each call (deterministic masks, as the JAX module's fixed key)."""

    def __init__(self, weight: Weight = None, ignore_index: int = -100, reduction: str = "mean", xi: int = 2,
                 alpha: float = 1.0, device: Device = torch.device("cuda")) -> None:
        super().__init__(weight, ignore_index, reduction, device)
        self.xi, self.alpha = xi, alpha

    def forward(self, x: torch.Tensor, target: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        return HF.mutual_channel_loss(x, target, generator, self.weight, self.ignore_index, self.reduction, self.xi,
                                      self.alpha)

    def extra_repr(self) -> str:
        return f"reduction='{self.reduction}', xi={self.xi}, alpha={self.alpha}"


class DiceLoss(_Loss):
    """Dice loss criterion (``loss.py:142-159``)."""

    def __init__(self, weight: Weight = None, gamma: float = 1.0, eps: float = 1e-8,
                 device: Device = torch.device("cuda")) -> None:
        super().__init__(weight, device=device)
        self.gamma, self.eps = gamma, eps

    def forward(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return HF.dice_loss(x, target, self.weight, self.gamma, self.eps)

    def extra_repr(self) -> str:
        return f"reduction='{self.reduction}', gamma={self.gamma}, eps={self.eps}"


class PolyLoss(_Loss):
    """Poly1 loss criterion (``loss.py:162-173``)."""

    def __init__(self, *args: Any, eps: float = 2.0, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.eps = eps

    def forward(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return HF.poly_loss(x, target, self.eps, self.weight, self.ignore_index, self.reduction)

    def extra_repr(self) -> str:
        return f"eps={self.eps}, reduction='{self.reduction}'"
