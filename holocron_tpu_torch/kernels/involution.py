"""Involution stencil: the port of ``holocron_tpu/kernels/involution.py``.

``out[n, h, w, c] = sum_{tap=(dy, dx)} kern[n, h, w, tap * G + c // (C / G)] * xp[n, h + dy, w + dx, c]``
for stride 1 and dilation 1, accumulated in float32 and stored in ``xp``'s dtype.
Layouts are the JAX package's: NHWC pre-padded ``xp`` and a tap-major kernel field.

On a CUDA tensor :func:`involution_stencil` launches the forward of
``csrc/involution.cu``, and :func:`involution_bwd_dxp` / :func:`involution_bwd_dkern`
its two backward kernels; on a CPU tensor each computes its plain version (``*_plain``),
the per-tap sums that the tests hold the kernels against. :class:`InvolutionStencil`
(``involution_stencil_ad``, as the JAX package names it) is the differentiable form:
the forward and the two gradients, each a kernel on the card.
"""

import ctypes

import torch

from ._build import FLOAT_DTYPES, Kernel, cuda_operands

__all__ = [
    "KERNEL",
    "KERNEL_DKERN",
    "KERNEL_DXP",
    "InvolutionStencil",
    "involution_bwd_dkern",
    "involution_bwd_dkern_plain",
    "involution_bwd_dxp",
    "involution_bwd_dxp_plain",
    "involution_stencil",
    "involution_stencil_ad",
    "involution_stencil_plain",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
KERNEL = Kernel("involution", "involution_forward", _ARGS)
KERNEL_DXP = Kernel("involution", "involution_backward_dxp", _ARGS)
KERNEL_DKERN = Kernel("involution", "involution_backward_dkern", _ARGS)


def _check(xp: torch.Tensor, kern: torch.Tensor, k: int, groups: int):
    if xp.ndim != 4 or kern.ndim != 4:
        raise ValueError("expected xp (N, H + k - 1, W + k - 1, C) and kern (N, H, W, k^2 * G)")
    n, hp, wp, c = xp.shape
    h, w = hp - (k - 1), wp - (k - 1)
    if c % groups:
        raise ValueError(f"channels ({c}) must be divisible by groups ({groups})")
    if tuple(kern.shape) != (n, h, w, k * k * groups):
        raise ValueError(f"kern shape {tuple(kern.shape)} != {(n, h, w, k * k * groups)}")
    return n, h, w, c


def involution_stencil_plain(xp: torch.Tensor, kern: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """The per-tap sum (``tests/test_kernels.py:108-111``) in float32, cast to ``xp``'s dtype."""
    n, h, w, c = _check(xp, kern, k, groups)
    cg = c // groups
    xf, kf = xp.float(), kern.float()
    out = torch.zeros((n, h, w, c), dtype=torch.float32, device=xp.device)
    for idx in range(k * k):
        dy, dx = divmod(idx, k)
        out += kf[..., idx * groups : (idx + 1) * groups].repeat_interleave(cg, dim=-1) * xf[:, dy : dy + h, dx : dx + w]
    return out.to(xp.dtype)


def involution_stencil(xp: torch.Tensor, kern: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """Applies the involution stencil (stride 1, dilation 1).

    Args:
        xp: ``(N, H + k - 1, W + k - 1, C)``, the pre-padded NHWC input
        kern: ``(N, H, W, k^2 * G)`` kernel field, tap-major (channel = tap * G + g)
        k: kernel size; groups: G (C must be divisible by it)
    """
    if xp.device.type == "cpu" and kern.device.type == "cpu":
        return involution_stencil_plain(xp, kern, k, groups)
    n, h, w, c = _check(xp, kern, k, groups)
    xp, kern = cuda_operands(xp, kern)
    out = torch.empty((n, h, w, c), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(xp.data_ptr(), kern.data_ptr(), out.data_ptr(), FLOAT_DTYPES[xp.dtype], n, h, w, c, groups, k, stream)
    return out


def _check_grad(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int, groups: int):
    n, h, w, c = _check(xp, kern, k, groups)
    if tuple(g.shape) != (n, h, w, c):
        raise ValueError(f"g shape {tuple(g.shape)} != {(n, h, w, c)}")
    return n, h, w, c


def involution_bwd_dxp_plain(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """``dxp``: for each tap in order, ``kern``'s group value times ``g`` added onto the
    tap's window (``_involution_bwd``, ``holocron_tpu/kernels/involution.py:100-117``),
    in float32, cast to ``xp``'s dtype."""
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    cg = c // groups
    kf, gf = kern.float(), g.float()
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=xp.device)
    for idx in range(k * k):
        dy, dx = divmod(idx, k)
        dxp[:, dy : dy + h, dx : dx + w] += kf[..., idx * groups : (idx + 1) * groups].repeat_interleave(cg, dim=-1) * gf
    return dxp.to(xp.dtype)


def involution_bwd_dkern_plain(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """``dkern[..., tap * G + j]``: the tap's window times ``g``, summed over group
    ``j``'s channels, in float32, cast to ``kern``'s dtype."""
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    xf, gf = xp.float(), g.float()
    taps = []
    for idx in range(k * k):
        dy, dx = divmod(idx, k)
        taps.append((xf[:, dy : dy + h, dx : dx + w] * gf).reshape(n, h, w, groups, c // groups).sum(-1))
    return torch.cat(taps, dim=-1).to(kern.dtype)


def involution_bwd_dxp(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """The gradient of :func:`involution_stencil` for ``xp``, given the cotangent ``g``
    of its output: the gather-form kernel on the card, the plain version on the CPU."""
    if g.device.type == "cpu" and kern.device.type == "cpu":
        return involution_bwd_dxp_plain(xp, kern, g, k, groups)
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    kern, g = cuda_operands(kern, g)
    dxp = torch.empty(xp.shape, dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL_DXP(kern.data_ptr(), g.data_ptr(), dxp.data_ptr(), FLOAT_DTYPES[g.dtype], n, h, w, c, groups, k, stream)
    return dxp


def involution_bwd_dkern(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """The gradient of :func:`involution_stencil` for ``kern``, given ``g``: the kernel
    on the card (a warp-shuffle sum over each group's channels), the plain version on
    the CPU."""
    if g.device.type == "cpu" and xp.device.type == "cpu":
        return involution_bwd_dkern_plain(xp, kern, g, k, groups)
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    xp, g = cuda_operands(xp, g)
    dkern = torch.empty(kern.shape, dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL_DKERN(xp.data_ptr(), g.data_ptr(), dkern.data_ptr(), FLOAT_DTYPES[g.dtype], n, h, w, c, groups, k, stream)
    return dkern


class InvolutionStencil(torch.autograd.Function):
    """:func:`involution_stencil` with its gradients for ``xp`` and ``kern``
    (``involution_stencil_ad``, ``holocron_tpu/kernels/involution.py:90-120``). All
    three take the kernels on the card and the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, xp: torch.Tensor, kern: torch.Tensor, k: int, groups: int) -> torch.Tensor:
        ctx.save_for_backward(xp, kern)
        ctx.k, ctx.groups = k, groups
        return involution_stencil(xp, kern, k, groups)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xp, kern = ctx.saved_tensors
        g = g.contiguous()
        dxp = involution_bwd_dxp(xp, kern, g, ctx.k, ctx.groups) if ctx.needs_input_grad[0] else None
        dkern = involution_bwd_dkern(xp, kern, g, ctx.k, ctx.groups) if ctx.needs_input_grad[1] else None
        return dxp, dkern, None, None


# the JAX package's name for the differentiable form
involution_stencil_ad = InvolutionStencil.apply
