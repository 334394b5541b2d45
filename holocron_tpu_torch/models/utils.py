"""Model helpers (``holocron_tpu/models/utils.py``): the conv block factory, conv/BN
fusion and the checkpoint metadata factory."""

import logging
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

from ..nn.modules.downsample import BlurPool2d
from .checkpoints import Checkpoint, Dataset, Evaluation, LoadingMeta, Metric, PreProcessing, TrainingRecipe
from .presets import IMAGENET, IMAGENETTE

__all__ = ["ConvSequence", "conv_sequence", "fuse_conv_bn"]

logger = logging.getLogger(__name__)


def conv_sequence(
    in_channels: int,
    out_channels: int,
    act_layer: Optional[nn.Module] = None,
    norm_layer: Optional[Callable[[int], nn.Module]] = None,
    drop_layer: Optional[Callable[[], nn.Module]] = None,
    conv_layer: Optional[Callable[..., nn.Module]] = None,
    bn_channels: Optional[int] = None,
    attention_layer: Optional[Callable[[int], nn.Module]] = None,
    blurpool: bool = False,
    **kwargs: Any,
) -> List[nn.Module]:
    """The conv block factory (``ConvSequence``, ``utils.py:44-156``): conv -> norm -> act ->
    blurpool -> attention -> drop, as a list in original Holocron's order, so that a
    ``Sequential`` of it holds the conv at offset 0, the norm at 1 and the activation
    at 2, the offsets the checkpoint converters read.

    Args:
        in_channels, out_channels: the conv's channels
        act_layer: an activation module (e.g. ``nn.ReLU(inplace=True)``), or None
        norm_layer: ``(channels) -> module``, or None
        drop_layer: ``() -> module``, or None
        conv_layer: ``(in_channels, out_channels, **kwargs) -> module`` in place of
            ``nn.Conv2d``
        bn_channels: the norm's (and attention's) channels, when they differ from
            ``out_channels``
        attention_layer: ``(channels) -> module``, or None
        blurpool: move a stride above 1 from the conv into a :class:`BlurPool2d`
        kwargs: the conv's arguments (``kernel_size``, ``stride``, ``padding``,
            ``dilation``, ``groups``, ``bias``); ``bias`` defaults to "no norm"
    """
    kwargs.setdefault("bias", norm_layer is None)
    conv_stride = kwargs.get("stride", 1)
    if blurpool and conv_stride > 1:
        kwargs["stride"] = 1
    channels = bn_channels or out_channels
    layers = [(conv_layer or nn.Conv2d)(in_channels, out_channels, **kwargs)]
    if norm_layer is not None:
        layers.append(norm_layer(channels))
    if act_layer is not None:
        layers.append(act_layer)
    if blurpool and conv_stride > 1:
        layers.append(BlurPool2d(channels, stride=conv_stride))
    if attention_layer is not None:
        layers.append(attention_layer(channels))
    if drop_layer is not None:
        layers.append(drop_layer())
    return layers


class ConvSequence(nn.Sequential):
    """A ``Sequential`` of :func:`conv_sequence`'s layers."""

    def __init__(self, in_channels: int, out_channels: int, **kwargs: Any) -> None:
        super().__init__(*conv_sequence(in_channels, out_channels, **kwargs))


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


def _checkpoint(
    arch: str,
    url: str,
    acc1: float,
    acc5: float,
    sha256: str,
    size: int,
    num_params: int,
    commit: Optional[str] = None,
    train_args: Optional[str] = None,
    dataset: Dataset = Dataset.IMAGENETTE,
) -> Checkpoint:
    """A checkpoint entry (``utils.py:365-387``); ``input_shape`` is channel-first."""
    preset = IMAGENETTE if dataset == Dataset.IMAGENETTE else IMAGENET
    return Checkpoint(
        evaluation=Evaluation(dataset=dataset, results={Metric.TOP1_ACC: acc1, Metric.TOP5_ACC: acc5}),
        meta=LoadingMeta(
            url=url, sha256=sha256, size=size, num_params=num_params, arch=arch, categories=preset.classes
        ),
        pre_processing=PreProcessing(input_shape=(3, 224, 224), mean=preset.mean, std=preset.std),
        recipe=TrainingRecipe(commit=commit, script="references/classification/train.py", args=train_args),
    )
