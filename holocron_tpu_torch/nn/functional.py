"""Functional ops (``holocron_tpu/nn/functional.py``): activations, the loss catalog,
structured dropout, space-to-depth and Z-pooling, and the slice-based convolutions
(AdderNet's, the normalized one).

The layouts are the JAX package's, so that each function takes what its counterpart
takes: logits are channel-last ``(N, ..., K)`` (for a classifier, ``(N, K)`` as in torch),
and the image functions (:func:`add2d`, :func:`norm_conv2d`, :func:`dropblock2d`,
:func:`concat_downsample2d`) take NHWC inputs and HWIO weights. The modules of
:mod:`holocron_tpu_torch.nn` keep torch's NCHW / OIHW and permute at the call.

Randomness comes from an explicit ``torch.Generator`` where the JAX package takes a
key. The two draw different numbers from one seed, so each random function is split
at its draw: :func:`dropblock2d_from_centers` and :func:`mutual_channel_loss_masked`
take the draw, and the tests feed them the JAX package's.
"""

from math import ceil
from typing import Optional, Tuple, Union

import torch
from torch.nn import functional as F

from ..kernels.add2d import add2d_matmul_ad

__all__ = [
    "add2d",
    "complement_cross_entropy",
    "concat_downsample2d",
    "cross_entropy",
    "dice_loss",
    "dropblock2d",
    "dropblock2d_from_centers",
    "extract_patches2d",
    "focal_loss",
    "hard_mish",
    "multilabel_cross_entropy",
    "mutual_channel_loss",
    "mutual_channel_loss_masked",
    "nl_relu",
    "norm_conv2d",
    "poly_loss",
    "z_pool",
]

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore[return-value]


def hard_mish(x: torch.Tensor) -> torch.Tensor:
    """HardMish: ``0.5 * x * clamp(x + 2, 0, 2)`` (``functional.py:46-52``)."""
    return 0.5 * x * torch.clamp(x + 2.0, 0.0, 2.0)


def nl_relu(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Natural-log ReLU: ``log(1 + beta * relu(x))`` (``functional.py:54-61``)."""
    return torch.log1p(beta * F.relu(x))


def _masked_reduce(loss: torch.Tensor, valid: torch.Tensor, reduction: str, target_shape) -> torch.Tensor:
    """``loss`` reduced over the elements where ``valid`` holds (``functional.py:67-80``):
    invalid ones add 0 to a sum and are left out of a mean's count."""
    valid = valid.to(loss.dtype)
    loss = loss * valid
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1.0)
    return loss.reshape(target_shape)


def _take_class(values: torch.Tensor, safe_target: torch.Tensor) -> torch.Tensor:
    """``values[..., target]`` for channel-last ``values`` and integer ``target``."""
    return values.gather(-1, safe_target.long().unsqueeze(-1)).squeeze(-1)


def _class_valid(num_classes: int, ignore_index: int, like: torch.Tensor) -> Optional[torch.Tensor]:
    """A ``(K,)`` mask that drops class ``ignore_index``, or None where it is no class."""
    if not 0 <= ignore_index < num_classes:
        return None
    return (torch.arange(num_classes, device=like.device) != ignore_index).to(like.dtype)


def cross_entropy(
    x: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
) -> torch.Tensor:
    """Cross-entropy on channel-last logits ``(N, ..., K)`` and integer targets
    ``(N, ...)`` (``functional.py:100-135``), with torch's weighted-mean denominator
    ``sum(w_target)`` over the targets that are not ``ignore_index``."""
    num_classes = x.shape[-1]
    logpt = F.log_softmax(x, dim=-1)
    safe_target = target.clamp(0, num_classes - 1).long()
    logpt_t = _take_class(logpt, safe_target)
    valid = target != ignore_index
    w_t = torch.ones_like(logpt_t) if weight is None else weight.to(x.dtype)[safe_target]
    loss = -w_t * logpt_t
    vf = valid.to(x.dtype)
    if reduction == "sum":
        return (loss * vf).sum()
    if reduction == "mean":
        return (loss * vf).sum() / (w_t * vf).sum().clamp_min(1e-12)
    return torch.where(valid, loss, torch.zeros((), dtype=loss.dtype, device=loss.device))


def multilabel_cross_entropy(
    x: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
) -> torch.Tensor:
    """Cross-entropy with dense (soft or multi-hot) targets of the shape of ``x``
    (``functional.py:158-194``): channel-last ``(N, ..., K)``; a class equal to
    ``ignore_index`` contributes nothing."""
    num_classes = x.shape[-1]
    logpt = F.log_softmax(x, dim=-1)
    if weight is not None:
        logpt = logpt * weight.to(x.dtype)
    loss = -target * logpt
    if 0 <= ignore_index < num_classes:
        class_valid = torch.arange(num_classes, device=x.device) != ignore_index
        loss = loss * class_valid.to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    loss = loss.sum(-1)
    if reduction == "mean":
        return loss.mean()
    return loss


def focal_loss(
    x: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
    gamma: float = 2.0,
) -> torch.Tensor:
    """Focal loss (`Lin et al. <https://arxiv.org/pdf/1708.02002.pdf>`_,
    ``functional.py:140-167``): cross-entropy scaled by ``(1 - p_t)^gamma``; a target
    equal to ``ignore_index`` counts only where it is a class, as in original Holocron."""
    num_classes = x.shape[-1]
    logpt = F.log_softmax(x, dim=-1)
    safe_target = target.clamp(0, num_classes - 1)
    logpt_t = _take_class(logpt, safe_target)
    pt = torch.exp(logpt_t)
    if weight is not None:
        logpt_t = weight.to(x.dtype)[safe_target.long()] * logpt_t
    loss = -1.0 * (1.0 - pt) ** gamma * logpt_t
    valid = target != ignore_index if 0 <= ignore_index < num_classes else torch.ones_like(target, dtype=torch.bool)
    return _masked_reduce(loss, valid, reduction, target.shape)


def complement_cross_entropy(
    x: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
    gamma: float = -1.0,
) -> torch.Tensor:
    """Complement cross-entropy (`Kim et al. <https://arxiv.org/pdf/2009.02189.pdf>`_,
    ``functional.py:197-238``): cross-entropy plus ``gamma`` times the entropy of the
    normalized non-target probabilities, the target class masked out by a one-hot."""
    ce = cross_entropy(x, target, weight, ignore_index, reduction)
    if gamma == 0:
        return ce
    num_classes = x.shape[-1]
    pt = F.softmax(x, dim=-1)
    safe_target = target.clamp(0, num_classes - 1).long()
    pt = pt / (1.0 - _take_class(pt, safe_target).unsqueeze(-1))
    loss = (-1.0 / (num_classes - 1)) * pt * torch.log(pt)
    loss = loss * (1.0 - F.one_hot(safe_target, num_classes).to(loss.dtype))
    class_valid = _class_valid(num_classes, ignore_index, loss)
    if class_valid is not None:
        loss = loss * class_valid
    if weight is not None:
        loss = loss * weight.to(x.dtype)
    if reduction == "sum":
        loss = loss.sum()
    else:
        loss = loss.sum(-1)
        if reduction == "mean":
            loss = loss.mean()
    return ce + gamma * loss


def mutual_channel_loss_masked(
    x: torch.Tensor,
    target: torch.Tensor,
    chan_mask: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
    xi: int = 2,
    alpha: float = 1.0,
) -> torch.Tensor:
    """:func:`mutual_channel_loss` after its random draw: ``chan_mask`` ``(K, xi)`` keeps
    ``ceil(xi / 2)`` of each group's ``xi`` features (channel-wise attention)."""
    b, c = x.shape[0], x.shape[-1]
    spatial = tuple(x.shape[1:-1])
    cnum = c // xi
    xg = x.reshape(b, -1, cnum, xi)
    # discriminality: CWA, cross-channel max pooling, cross-entropy
    discr = (xg * chan_mask.to(x.dtype)).amax(-1).reshape(b, *spatial, cnum)
    discr_loss = cross_entropy(discr, target, weight, ignore_index, reduction)
    # diversity: softmax over positions, max over each group, mean over the groups
    diversity = F.softmax(xg, dim=1).amax(-1).mean(-1)
    if reduction == "sum":
        diversity = diversity.sum()
    elif reduction == "mean":
        diversity = diversity.mean()
    else:
        diversity = diversity.reshape(b, *spatial)
    return discr_loss - alpha * diversity


def mutual_channel_loss(
    x: torch.Tensor,
    target: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
    xi: int = 2,
    alpha: float = 1.0,
) -> torch.Tensor:
    """Mutual-channel loss (`Chang et al. <https://arxiv.org/pdf/2002.04264.pdf>`_,
    ``functional.py:241-286``) on channel-last ``x`` ``(N, ..., K * xi)``:
    discriminality minus ``alpha`` times diversity. Each group's channel mask is a
    random permutation of ``ceil(xi / 2)`` ones and the rest zeros, drawn from
    ``generator`` (on ``x``'s device), then :func:`mutual_channel_loss_masked`."""
    cnum = x.shape[-1] // xi
    base = (torch.arange(xi, device=x.device) < ceil(xi / 2)).to(x.dtype)
    chan_mask = torch.stack([base[torch.randperm(xi, generator=generator, device=x.device)] for _ in range(cnum)])
    return mutual_channel_loss_masked(x, target, chan_mask, weight, ignore_index, reduction, xi, alpha)


def dice_loss(
    x: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    gamma: float = 1.0,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Soft Dice loss (`Milletari et al. <https://arxiv.org/pdf/1606.04797.pdf>`_,
    ``functional.py:289-309``) on channel-last probabilities: per-class statistics over
    the batch and spatial axes, ``gamma`` weighing recall against precision."""
    axes = tuple(range(x.ndim - 1))
    inter = gamma * (x * target).sum(axes)
    cardinality = (x + gamma * target).sum(axes)
    dice_coeff = (inter + eps) / (cardinality + eps)
    if weight is None:
        return 1.0 - (1.0 + 1.0 / gamma) * dice_coeff.mean()
    weight = weight.to(x.dtype)
    return 1.0 - (1.0 + 1.0 / gamma) * (weight * dice_coeff).sum() / weight.sum()


def poly_loss(
    x: torch.Tensor,
    target: torch.Tensor,
    eps: float = 2.0,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
) -> torch.Tensor:
    """Poly1 loss (`Leng et al. <https://arxiv.org/pdf/2204.12511.pdf>`_,
    ``functional.py:312-364``): ``CE + eps * (1 - p_t)``, for integer targets ``(N, ...)``
    or soft targets of ``x``'s shape."""
    num_classes = x.shape[-1]
    logpt = F.log_softmax(x, dim=-1)
    hard = target.ndim == x.ndim - 1
    if hard:
        if target.dtype.is_floating_point or target.dtype.is_complex or target.dtype == torch.bool:
            raise TypeError("target dtype is expected to be an integer type")
        safe_target = target.clamp(0, num_classes - 1).long()
        logpt_t = _take_class(logpt, safe_target)
    else:
        if target.ndim != x.ndim or target.shape[0] != x.shape[0] or target.shape[-1] != x.shape[-1]:
            raise ValueError("invalid target shape")
        logpt_t = logpt * target
    loss = -1.0 * logpt_t + eps * (1.0 - torch.exp(logpt_t))
    if weight is not None:
        weight = weight.to(x.dtype)
        loss = (weight[safe_target] if hard else weight) * loss
    if hard:
        valid = target != ignore_index if 0 <= ignore_index < num_classes else torch.ones_like(target, dtype=torch.bool)
        return _masked_reduce(loss, valid, reduction, target.shape)
    class_valid = _class_valid(num_classes, ignore_index, loss)
    if class_valid is not None:
        loss = loss * class_valid
    if reduction == "sum":
        return loss.sum()
    loss = loss.sum(-1)
    if reduction == "mean":
        return loss.mean()
    return loss


def concat_downsample2d(x: torch.Tensor, scale_factor: int) -> torch.Tensor:
    """Loss-less space-to-depth of `YOLO9000 <https://pjreddie.com/media/files/papers/YOLO9000.pdf>`_
    (``functional.py:372-387``): NHWC ``(N, H, W, C) -> (N, H/s, W/s, s*s*C)``, channels
    ordered ``(sh, sw, c)`` as original Holocron's."""
    b, h, w, c = x.shape
    s = scale_factor
    if h % s != 0 or w % s != 0:
        raise AssertionError("Spatial size of input tensor must be multiples of `scale_factor`")
    x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // s, w // s, s * s * c)


def z_pool(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Z-pool (`Misra et al. <https://arxiv.org/pdf/2010.03045.pdf>`_,
    ``functional.py:390-399``): the max and the mean along ``axis``, concatenated there."""
    return torch.cat([x.amax(axis, keepdim=True), x.mean(axis, keepdim=True)], dim=axis)


def dropblock2d_from_centers(x: torch.Tensor, centers: torch.Tensor, block_size: int) -> torch.Tensor:
    """:func:`dropblock2d` after its random draw: ``centers`` ``(N, H, W)`` marks the
    dropped blocks' centers with ones; each grows to a ``block_size`` square (a stride-1
    max pool padded ``block_size // 2`` before and ``(block_size - 1) // 2`` after), the
    kept values of the NHWC ``x`` are rescaled by ``mask.numel() / mask.sum()``."""
    lo, hi = block_size // 2, (block_size - 1) // 2
    # centers are 0 or 1 and each window holds its own center: padding with 0 is -inf's max
    padded = F.pad(centers.to(x.dtype).unsqueeze(1), (lo, hi, lo, hi))
    mask = 1.0 - F.max_pool2d(padded, block_size, 1).squeeze(1)
    one_count = mask.sum()
    scale = torch.where(one_count > 0, mask.numel() / one_count.clamp_min(1.0), torch.ones_like(one_count))
    return x * mask.unsqueeze(-1) * scale


def dropblock2d(
    x: torch.Tensor,
    drop_prob: float,
    block_size: int,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """DropBlock (`Ghiasi et al. <https://arxiv.org/pdf/1810.12890.pdf>`_,
    ``functional.py:407-439``) on an NHWC ``x``: block centers drawn with probability
    ``drop_prob / block_size**2`` from ``generator`` (on ``x``'s device), then
    :func:`dropblock2d_from_centers`."""
    if not training or drop_prob == 0:
        return x
    n, h, w, _ = x.shape
    gamma = drop_prob / block_size**2
    centers = torch.rand((n, h, w), generator=generator, device=x.device) <= gamma
    return dropblock2d_from_centers(x, centers, block_size)


def extract_patches2d(
    x: torch.Tensor,
    kernel_size: Tuple[int, int],
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
) -> torch.Tensor:
    """im2col of an NHWC input (``functional.py:452-483``): ``(N, H', W', kh * kw * C)``
    with the patch vector ordered ``(kh, kw, c)``, so that an HWIO kernel flattened to
    ``(kh * kw * C, O)`` lines up."""
    kh, kw = kernel_size
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, h, w, c = x.shape
    out_h = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    out_w = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = F.pad(x, (0, 0, pw, pw, ph, ph))
    rows = [
        x[:, i * dh : i * dh + (out_h - 1) * sh + 1 : sh, j * dw : j * dw + (out_w - 1) * sw + 1 : sw]
        for i in range(kh)
        for j in range(kw)
    ]
    return torch.stack(rows, dim=3).reshape(n, out_h, out_w, kh * kw * c)


def _normalize_slices(patches: torch.Tensor, eps: float) -> torch.Tensor:
    """Variance-normalizes each patch vector with the biased variance
    (``functional.py:486-491``)."""
    mean = patches.mean(-1, keepdim=True)
    var = patches.var(-1, unbiased=False, keepdim=True)
    return (patches - mean) * torch.rsqrt(var + eps)


def add2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
    normalize_slices: bool = False,
    eps: float = 1e-14,
) -> torch.Tensor:
    """Adder "convolution" (`AdderNet <https://arxiv.org/pdf/1912.13200.pdf>`_,
    ``functional.py:523-563``): ``out[o] = -sum_d |patch[d] - w[d, o]|``.

    ``x`` is NHWC, ``weight`` HWIO ``(kh, kw, C, O)``, ``bias`` ``(O,)``. The patches and
    their optional normalization are plain torch; the L1 "matmul" is
    :func:`~holocron_tpu_torch.kernels.add2d.add2d_matmul_ad`, which launches the CUDA
    kernels (forward and both gradients) on a CUDA tensor and takes the plain chunked
    version on a CPU tensor. There is no ``use_pallas`` switch: the JAX package chose
    XLA's fused broadcast on the TPU, while eager torch would materialize the
    ``(L, D, O)`` broadcast, so a CUDA tensor always takes the kernel.
    """
    kh, kw, _, o = weight.shape
    patches = extract_patches2d(x, (kh, kw), stride, padding, dilation)
    if normalize_slices:
        patches = _normalize_slices(patches, eps)
    n, oh, ow, d = patches.shape
    out = add2d_matmul_ad(patches.reshape(-1, d), weight.reshape(-1, o)).reshape(n, oh, ow, o)
    if bias is not None:
        out = out + bias
    return out


def norm_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
    eps: float = 1e-14,
) -> torch.Tensor:
    """Normalized convolution (`Kim <https://github.com/kimdongsuk1/NormalizedCNN>`_,
    ``functional.py:494-520``): each input slice variance-normalized, then the product
    with the kernel. ``x`` NHWC, ``weight`` HWIO ``(kh, kw, C, O)``, ``bias`` ``(O,)``."""
    kh, kw, _, o = weight.shape
    patches = _normalize_slices(extract_patches2d(x, (kh, kw), stride, padding, dilation), eps)
    out = patches @ weight.reshape(-1, o)
    if bias is not None:
        out = out + bias
    return out
