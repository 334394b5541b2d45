"""Convolution-like modules (``holocron_tpu/nn/modules/conv.py``)."""

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from ...kernels.involution import involution_stencil_ad
from .. import functional as HF
from ..init import kaiming_normal_

__all__ = ["Add2d", "Involution2d"]

_PAD_MODES = ("zeros", "reflect", "replicate", "circular")


class _SliceConv(nn.Module):
    """Parameters of the im2col-based conv variants (``conv.py:85-122``), in torch's
    layout: ``weight`` ``(O, C, kh, kw)`` drawn from ``U(-sqrt(3) b, sqrt(3) b)`` and
    ``bias`` from ``U(-b, b)``, ``b = 1 / sqrt(C * kh * kw)``, from the caller's
    generator on the CPU, then moved to ``device`` (the card unless the caller asks for
    the CPU). NCHW input; ``padding_mode`` other than ``"zeros"`` pads explicitly."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]],
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Union[int, Tuple[int, int]] = 0,
        dilation: Union[int, Tuple[int, int]] = 1,
        bias: bool = True,
        padding_mode: str = "zeros",
        eps: float = 1e-14,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if padding_mode not in _PAD_MODES:
            raise ValueError(f"padding_mode must be one of {_PAD_MODES}, got {padding_mode!r}")
        kh, kw = HF._pair(kernel_size)
        self.stride, self.padding, self.dilation = HF._pair(stride), HF._pair(padding), HF._pair(dilation)
        self.padding_mode, self.eps = padding_mode, eps
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        weight = torch.empty(out_channels, in_channels, kh, kw)
        weight.uniform_(-bound * math.sqrt(3), bound * math.sqrt(3), generator=generator)
        self.weight = nn.Parameter(weight)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound, generator=generator))
        self.to(device)

    def _padded_input(self, x: torch.Tensor):
        """``conv.py:117-122``: explicit padding for non-zero modes, else the padding
        goes to the op."""
        if self.padding_mode != "zeros":
            ph, pw = self.padding
            return F.pad(x, (pw, pw, ph, ph), mode=self.padding_mode), (0, 0)
        return x, self.padding

    def _hwio(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0)


class Add2d(_SliceConv):
    """AdderNet layer (`Chen et al. <https://arxiv.org/pdf/1912.13200.pdf>`_,
    ``conv.py:138-151``): ``-sum |patch - w|`` in place of the dot product, through
    :func:`~holocron_tpu_torch.nn.functional.add2d` (the CUDA kernels on the card).
    NCHW in and out; the input is viewed as NHWC, free when it lies channels_last."""

    def __init__(self, *args, normalize_slices: bool = False, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.normalize_slices = normalize_slices

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = self._padded_input(x)
        out = HF.add2d(x.permute(0, 2, 3, 1), self._hwio(), self.bias, self.stride, pad, self.dilation,
                       self.normalize_slices, self.eps)
        return out.permute(0, 3, 1, 2)


class Involution2d(nn.Module):
    """Involution (`Li et al. <https://arxiv.org/pdf/2103.06255.pdf>`_): the kernel is
    generated from the input (``reduce`` then ``span``, two biased 1x1 convs), then
    applied to each ``kernel_size``-square neighbourhood (``conv.py:342-403``). NCHW.

    Stride 1 and dilation 1 go through :func:`~holocron_tpu_torch.kernels.involution.involution_stencil_ad`,
    which launches the CUDA kernels (forward and both gradients) on a CUDA tensor;
    the JAX package's VMEM-fit gate
    has no counterpart on the card. Strided or dilated involutions take the
    shift-accumulate form, the JAX package's own path for those cases.
    """

    def __init__(
        self,
        in_channels: int,
        kernel_size: int,
        padding: int = 0,
        stride: int = 1,
        groups: int = 1,
        dilation: int = 1,
        reduction_ratio: float = 1.0,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if in_channels % groups:
            raise ValueError("in_channels must be divisible by groups")
        self.kernel_size, self.padding, self.stride = kernel_size, padding, stride
        self.groups, self.dilation = groups, dilation
        mid = int(in_channels // reduction_ratio)
        self.reduce = nn.Conv2d(in_channels, mid, 1)
        self.span = nn.Conv2d(mid, kernel_size**2 * groups, 1)
        for conv in (self.reduce, self.span):
            kaiming_normal_(conv.weight, generator=generator)
            nn.init.zeros_(conv.bias)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        k, g = self.kernel_size, self.groups
        kern_in = F.avg_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        kern = self.span(self.reduce(kern_in))  # (N, G * k^2, OH, OW), g-major channels
        oh, ow = kern.shape[2:]
        xp = F.pad(x, (self.padding,) * 4) if self.padding else x
        # NHWC views: free when x lies channels_last
        xp_nhwc = xp.permute(0, 2, 3, 1)
        if self.stride == 1 and self.dilation == 1:
            # the stencil wants tap-major channels (channel = tap * G + g), conv.py:384
            kern_t = kern.permute(0, 2, 3, 1).reshape(n, oh, ow, g, k * k).transpose(-1, -2)
            kern_t = kern_t.reshape(n, oh, ow, k * k * g).to(x.dtype)
            return involution_stencil_ad(xp_nhwc, kern_t, k, g).permute(0, 3, 1, 2)

        # shift-and-accumulate over a full-C kernel field (conv.py:389-403)
        kern_full = kern.permute(0, 2, 3, 1).reshape(n, oh, ow, g, 1, k * k)
        kern_full = kern_full.expand(n, oh, ow, g, c // g, k * k).reshape(n, oh, ow, c, k * k)
        y_span = (oh - 1) * self.stride + 1
        x_span = (ow - 1) * self.stride + 1
        out = torch.zeros((n, oh, ow, c), dtype=x.dtype, device=x.device)
        for idx in range(k * k):  # row-major tap order (matches the unfold)
            dy, dx = divmod(idx, k)
            ys, xs = dy * self.dilation, dx * self.dilation
            sl = xp_nhwc[:, ys : ys + y_span : self.stride, xs : xs + x_span : self.stride]
            out = out + kern_full[..., idx] * sl
        return out.permute(0, 3, 1, 2)
