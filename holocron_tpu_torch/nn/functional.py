"""Functional ops (``holocron_tpu/nn/functional.py``): the losses of the classification
trainer and the slice-based AdderNet convolution.

The layouts are the JAX package's, so that each function takes what its counterpart
takes: logits are channel-last ``(N, ..., K)`` (for a classifier, ``(N, K)`` as in torch),
and :func:`add2d` takes an NHWC input and an HWIO weight. :class:`~holocron_tpu_torch.nn.Add2d`
keeps torch's NCHW / OIHW at the module and permutes at the call.
"""

from typing import Optional, Tuple, Union

import torch
from torch.nn import functional as F

from ..kernels.add2d import add2d_matmul_ad

__all__ = ["add2d", "cross_entropy", "extract_patches2d", "multilabel_cross_entropy"]

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore[return-value]


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
    logpt_t = logpt.gather(-1, safe_target.unsqueeze(-1)).squeeze(-1)
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
