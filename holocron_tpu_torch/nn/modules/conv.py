"""Convolution-like modules (``holocron_tpu/nn/modules/conv.py``)."""

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ...kernels.involution import involution_stencil
from ..init import kaiming_normal_

__all__ = ["Involution2d"]


class Involution2d(nn.Module):
    """Involution (`Li et al. <https://arxiv.org/pdf/2103.06255.pdf>`_): the kernel is
    generated from the input (``reduce`` then ``span``, two biased 1x1 convs), then
    applied to each ``kernel_size``-square neighbourhood (``conv.py:342-403``). NCHW.

    Stride 1 and dilation 1 go through :func:`~holocron_tpu_torch.kernels.involution.involution_stencil`,
    which launches the CUDA kernel on a CUDA tensor; the JAX package's VMEM-fit gate
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
        device: Optional[torch.device] = None,
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
            return involution_stencil(xp_nhwc, kern_t, k, g).permute(0, 3, 1, 2)

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
