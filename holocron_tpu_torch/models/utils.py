"""Model helpers (``holocron_tpu/models/utils.py``)."""

import logging
from typing import Optional, Tuple

import torch

__all__ = ["fuse_conv_bn"]

logger = logging.getLogger(__name__)


def fuse_conv_bn(
    weight: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    conv_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algebraic conv+BN fusion, the core of RepVGG reparametrization
    (``holocron_tpu/models/utils.py:159-185``).

    Args:
        weight: OIHW conv weight ``(out_c, in_c, kh, kw)``
        bn_scale, bn_bias, bn_mean, bn_var: BN parameters and statistics, each ``(out_c,)``

    Returns:
        ``(fused_weight, fused_bias)``, in the same operation order as the JAX package.
    """
    if bn_bias.shape[0] != weight.shape[0]:
        raise AssertionError("expected same number of output channels for both `conv` and `bn`")
    scale_factor = bn_scale / torch.sqrt(bn_var + eps)
    fused_bias = bn_bias - scale_factor * bn_mean
    if conv_bias is not None:
        logger.warning("convolution layers placed before batch normalization should not have a bias.")
        fused_bias = fused_bias + scale_factor * conv_bias
    fused_weight = weight * scale_factor.reshape(-1, *([1] * (weight.ndim - 1)))
    return fused_weight, fused_bias
