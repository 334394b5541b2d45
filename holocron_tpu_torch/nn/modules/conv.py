"""Convolution-like modules (``holocron_tpu/nn/modules/conv.py``)."""

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from ...kernels.involution import involution_stencil_ad
from .. import functional as HF
from ..init import kaiming_normal_
from ._norm import FlaxBatchNorm2d

__all__ = ["Add2d", "Involution2d", "NormConv2d", "PyConv2d", "SlimConv2d"]

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


class NormConv2d(_SliceConv):
    """Normalized convolution (`Kim <https://arxiv.org/pdf/2005.05274v2.pdf>`_,
    ``conv.py:124-135``): a conv over variance-normalized input slices, through
    :func:`~holocron_tpu_torch.nn.functional.norm_conv2d` (im2col, the normalization of
    each slice, then a product with the kernel). NCHW in and out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = self._padded_input(x)
        out = HF.norm_conv2d(x.permute(0, 2, 3, 1), self._hwio(), self.bias, self.stride, pad, self.dilation, self.eps)
        return out.permute(0, 3, 1, 2)


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


class SlimConv2d(nn.Module):
    """SlimConv (`Qiu et al. <https://arxiv.org/pdf/2003.07469.pdf>`_, ``conv.py:154-198``):
    SE-style channel weights ``w`` (``fc1``, ``bn``, ReLU, ``fc2``, sigmoid), the halves
    of ``x * w`` and of ``x * flip(w)`` summed, a ``kernel_size`` conv on the first
    (``conv_top``, ``C / 2`` channels) and a 1x1 then a ``kernel_size`` conv on the
    second (``conv_bot1``, ``conv_bot2``, ``C / 4``), concatenated: ``C / 2 + C / 4``
    channels out. NCHW; ``in_channels`` even.

    Weights are drawn from ``generator`` on the CPU (fan-out He-normal, zero biases),
    then the module moves to ``device``: the card unless the caller asks for the CPU.
    The norm is flax's (:class:`FlaxBatchNorm2d`), momentum 0.1 in torch's convention.
    """

    def __init__(
        self,
        in_channels: int,
        kernel_size: Union[int, Tuple[int, int]] = 3,
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Union[int, Tuple[int, int]] = 0,
        dilation: Union[int, Tuple[int, int]] = 1,
        bias: bool = True,
        r: int = 32,
        L: int = 2,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        squeezed = max(in_channels // r, L)
        half, quarter = in_channels // 2, in_channels // 4
        conv_kw = {"kernel_size": kernel_size, "stride": stride, "padding": padding, "dilation": dilation, "bias": bias}
        self.fc1 = nn.Conv2d(in_channels, squeezed, 1)
        self.bn = FlaxBatchNorm2d(squeezed)
        self.fc2 = nn.Conv2d(squeezed, in_channels, 1)
        self.conv_top = nn.Conv2d(half, half, **conv_kw)
        self.conv_bot1 = nn.Conv2d(half, quarter, 1)
        self.conv_bot2 = nn.Conv2d(quarter, quarter, **conv_kw)
        for conv in (self.fc1, self.fc2, self.conv_top, self.conv_bot1, self.conv_bot2):
            kaiming_normal_(conv.weight, generator=generator)
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.fc1(x.mean(dim=(2, 3), keepdim=True))
        w = torch.sigmoid(self.fc2(F.relu(self.bn(z))))
        half = x.shape[1] // 2
        x_w = x * w
        x_top = x_w[:, :half] + x_w[:, half:]
        x_w = x * w.flip(1)
        x_bot = x_w[:, :half] + x_w[:, half:]
        return torch.cat([self.conv_top(x_top), self.conv_bot2(self.conv_bot1(x_bot))], dim=1)


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


class PyConv2d(nn.ModuleList):
    """Pyramidal convolution (`Duta et al. <https://arxiv.org/pdf/2006.11538.pdf>`_,
    ``conv.py:262-340``): ``num_levels`` parallel convs of growing kernel size (k, k + 2,
    ...), padding and groups, their outputs concatenated along channels. A
    ``ModuleList`` of native grouped ``nn.Conv2d``, one a level (keys ``{k}.weight``), as
    original Holocron; the JAX package's masked dense form of grouped levels is a TPU
    workaround with the same parameters.

    Output channels split by powers of two (:meth:`level_plan`); ``groups`` defaults to
    ``[1, 4, 8, ...]``, each capped at its level's output channels. Weights are drawn
    from ``generator`` on the CPU (fan-out He-normal, zero bias), then moved to
    ``device``: the card unless the caller asks for the CPU.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        num_levels: int = 2,
        padding: int = 0,
        groups: Optional[Sequence[int]] = None,
        bias: bool = True,
        stride: int = 1,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_levels = num_levels
        for oc, k, p, g in zip(*self.level_plan(out_channels, kernel_size, num_levels, padding, groups)):
            conv = nn.Conv2d(in_channels, oc, k, stride, p, groups=g, bias=bias)
            kaiming_normal_(conv.weight, generator=generator)
            if bias:
                nn.init.zeros_(conv.bias)
            self.append(conv)
        self.to(device)

    @staticmethod
    def level_plan(
        out_channels: int, kernel_size: int, num_levels: int, padding: int, groups: Optional[Sequence[int]]
    ) -> Tuple[List[int], List[int], List[int], List[int]]:
        """Per level: output channels, kernel size, padding and groups (``_level_plan``,
        ``conv.py:283-303``). With ``2^e <= num_levels`` levels and ``r = num_levels -
        2^e``, the first ``2r`` levels take ``out / 2^(e + 1)`` channels and the others
        ``out / 2^e``."""
        if num_levels == 1:
            g = groups[0] if isinstance(groups, (list, tuple)) else 1
            return [out_channels], [kernel_size], [padding], [g]
        exp2 = int(math.log2(num_levels))
        reminder = num_levels - 2**exp2
        out_chans = [out_channels // 2 ** (exp2 + 1)] * (2 * reminder) + [out_channels // 2**exp2] * (
            num_levels - 2 * reminder
        )
        k_sizes = [kernel_size + 2 * idx for idx in range(num_levels)]
        if groups is None:
            groups = [1] + [min(2 ** (2 + idx), out_chan) for idx, out_chan in zip(range(num_levels - 1), out_chans[1:])]
        elif not isinstance(groups, (list, tuple)) or len(groups) != num_levels:
            raise ValueError("The argument `groups` is expected to be a list of integer of size `num_levels`.")
        paddings = [padding + idx for idx in range(num_levels)]
        return out_chans, k_sizes, paddings, list(groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if len(self) == 1:
            return self[0](x)
        return torch.cat([conv(x) for conv in self], dim=1)
