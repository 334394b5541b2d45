"""Parameter initializers matching ``holocron_tpu.nn.init`` (holocron/nn/init.py:10-24).

Every initializer takes an explicit ``torch.Generator`` so that a seed fixes the
weights. Weights are drawn on the generator's device (the CPU for the factories of
this package), then moved, so one seed gives the same weights on every device.
"""

import math
from typing import Optional

import torch

__all__ = ["kaiming_normal_", "lecun_normal_"]


def _gain(nonlinearity: str, param: float = 0.01) -> float:
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + param**2))
    if nonlinearity in ("linear", "conv2d", "sigmoid"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    raise ValueError(f"unsupported nonlinearity: {nonlinearity}")


@torch.no_grad()
def kaiming_normal_(
    tensor: torch.Tensor,
    nonlinearity: str = "relu",
    neg_slope: float = 0.01,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """He-normal with ``mode='fan_out'`` on an ``(out_c, in_c/groups, kh, kw)`` weight
    (``holocron_tpu/nn/init.py:30-47``): ``std = gain / sqrt(out_c * kh * kw)``."""
    fan_out = tensor.shape[0] * math.prod(tensor.shape[2:])
    return tensor.normal_(0.0, _gain(nonlinearity, neg_slope) / math.sqrt(fan_out), generator=generator)


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """LeCun normal on an ``(out, in)`` weight: the default kernel init of the JAX
    package's ``nn.Dense`` (a normal truncated at two standard deviations, rescaled
    so that the variance is ``1 / fan_in``)."""
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    std = 1.0 / math.sqrt(tensor.shape[1]) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
