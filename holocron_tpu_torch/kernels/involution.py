"""Involution stencil: the port of ``holocron_tpu/kernels/involution.py``.

``out[n, h, w, c] = sum_{tap=(dy, dx)} kern[n, h, w, tap * G + c // (C / G)] * xp[n, h + dy, w + dx, c]``
for stride 1 and dilation 1, accumulated in float32 and stored in ``xp``'s dtype.
Layouts are the JAX package's: NHWC pre-padded ``xp`` and a tap-major kernel field.

On CUDA tensors the forward and the two gradients take one of the two routes of
``csrc/involution.cu``, chosen by shape alone in :func:`bwd_route`: the tiled kernels (a
shared-memory halo tile, 16-byte vectors), where a group's channels are whole 16-byte
vectors (:func:`involution_stencil_tiled`, :func:`involution_bwd_dxp`,
:func:`involution_bwd_dkern`), and the general ones for every other shape
(:func:`involution_stencil_general`, :func:`involution_bwd_dxp_general`,
:func:`involution_bwd_dkern_general`). :func:`involution_stencil` takes any shape and
picks the route. On a CPU tensor each computes its plain version (``*_plain``), the
per-tap sums that the tests hold the kernels against. :class:`InvolutionStencil`
(``involution_stencil_ad``, as the JAX package names it) is the differentiable form: the
forward and the two gradients, each a kernel on the card.
"""

import ctypes

import torch

from ._build import FLOAT_DTYPES, Kernel, cuda_operands

__all__ = [
    "KERNEL",
    "KERNEL_DKERN",
    "KERNEL_DKERN_GENERAL",
    "KERNEL_DXP",
    "KERNEL_DXP_GENERAL",
    "KERNEL_GENERAL",
    "InvolutionStencil",
    "bwd_route",
    "involution_bwd_dkern",
    "involution_bwd_dkern_general",
    "involution_bwd_dkern_plain",
    "involution_bwd_dxp",
    "involution_bwd_dxp_general",
    "involution_bwd_dxp_plain",
    "involution_stencil",
    "involution_stencil_ad",
    "involution_stencil_general",
    "involution_stencil_plain",
    "involution_stencil_tiled",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
KERNEL = Kernel("involution", "involution_forward", _ARGS)
KERNEL_GENERAL = Kernel("involution", "involution_forward_general", _ARGS)
KERNEL_DXP = Kernel("involution", "involution_backward_dxp", _ARGS)
KERNEL_DKERN = Kernel("involution", "involution_backward_dkern", _ARGS)
KERNEL_DXP_GENERAL = Kernel("involution", "involution_backward_dxp_general", _ARGS)
KERNEL_DKERN_GENERAL = Kernel("involution", "involution_backward_dkern_general", _ARGS)
# the tiled kernels index in 32 bits
INDEX_LIMIT = 2**31


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
    """Applies the involution stencil (stride 1, dilation 1), for any shape: on the card
    through the route :func:`bwd_route` picks from the shape, on the CPU the plain
    version.

    Args:
        xp: ``(N, H + k - 1, W + k - 1, C)``, the pre-padded NHWC input
        kern: ``(N, H, W, k^2 * G)`` kernel field, tap-major (channel = tap * G + g)
        k: kernel size; groups: G (C must be divisible by it)
    """
    tiled = bwd_route(xp.shape[-1], groups, xp.dtype) == "tiled"
    return (involution_stencil_tiled if tiled else involution_stencil_general)(xp, kern, k, groups)


def involution_stencil_tiled(xp: torch.Tensor, kern: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """:func:`involution_stencil` on the card by the tiled kernel (raises where
    :func:`bwd_route` is not ``"tiled"``), bit for bit the plain version, which it
    computes on the CPU."""
    if xp.device.type == "cpu" and kern.device.type == "cpu":
        return involution_stencil_plain(xp, kern, k, groups)
    n, h, w, c = _check(xp, kern, k, groups)
    return _launch(KERNEL, True, (xp, kern), (n, h, w, c), n, h, w, c, k, groups)


def involution_stencil_general(xp: torch.Tensor, kern: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """:func:`involution_stencil` for any shape: on the card the general route's kernel
    (one thread per element, bit for bit the plain version), on the CPU the plain
    version."""
    if xp.device.type == "cpu" and kern.device.type == "cpu":
        return involution_stencil_plain(xp, kern, k, groups)
    n, h, w, c = _check(xp, kern, k, groups)
    return _launch(KERNEL_GENERAL, False, (xp, kern), (n, h, w, c), n, h, w, c, k, groups)


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


def bwd_route(c: int, groups: int, dtype: torch.dtype) -> str:
    """The route the forward and the backward of a CUDA involution with ``c`` channels
    in ``groups`` groups take: ``"tiled"`` where a group's channels are whole 16-byte
    vectors (``(c / groups) * itemsize % 16 == 0``, float32 or bfloat16), else
    ``"general"``."""
    return "tiled" if dtype in FLOAT_DTYPES and (c // groups) * dtype.itemsize % 16 == 0 else "general"


def _launch(kernel: Kernel, tiled: bool, ins, out_shape, n: int, h: int, w: int, c: int, k: int, groups: int):
    """Launches one kernel on ``ins`` (two tensors) into a new tensor of ``out_shape``;
    raises on what the route does not take."""
    # xp, and kern as if it spanned the padded grid (the dxp kernel's offsets reach that far)
    padded = n * (h + k - 1) * (w + k - 1)
    if tiled and padded * max(c, k * k * groups) >= INDEX_LIMIT:
        raise ValueError(f"the tiled involution kernels index in 32 bits: (N, H + k - 1, W + k - 1) x "
                         f"max(C, k^2 G) must be below 2^31, got {(n, h + k - 1, w + k - 1)} x {max(c, k * k * groups)}")
    a, b = cuda_operands(*ins)
    if tiled and bwd_route(c, groups, a.dtype) != "tiled":
        raise ValueError(f"the tiled involution kernels need whole 16-byte vectors in a group: "
                         f"(C / G) * itemsize = {c // groups * a.dtype.itemsize} bytes")
    if tiled:  # 16-byte copies: a view that starts off a 16-byte boundary is copied first
        a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    if out.numel():
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), FLOAT_DTYPES[a.dtype], n, h, w, c, groups, k, stream)
    return out


def involution_bwd_dxp(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """The gradient of :func:`involution_stencil` for ``xp``, given the cotangent ``g``
    of its output: on the card the tiled kernel (raises where :func:`bwd_route` is not
    ``"tiled"``), bit for bit the plain version, which it computes on the CPU."""
    if g.device.type == "cpu" and kern.device.type == "cpu":
        return involution_bwd_dxp_plain(xp, kern, g, k, groups)
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    return _launch(KERNEL_DXP, True, (kern, g), xp.shape, n, h, w, c, k, groups)


def involution_bwd_dkern(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """The gradient of :func:`involution_stencil` for ``kern``, given ``g``: on the card
    the tiled kernel (raises where :func:`bwd_route` is not ``"tiled"``), on the CPU the
    plain version."""
    if g.device.type == "cpu" and xp.device.type == "cpu":
        return involution_bwd_dkern_plain(xp, kern, g, k, groups)
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    return _launch(KERNEL_DKERN, True, (xp, g), kern.shape, n, h, w, c, k, groups)


def involution_bwd_dxp_general(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int,
                               groups: int) -> torch.Tensor:
    """:func:`involution_bwd_dxp` for any shape: on the card the general route's
    gather-form kernel (one thread per element, bit for bit the plain version), on the
    CPU the plain version."""
    if g.device.type == "cpu" and kern.device.type == "cpu":
        return involution_bwd_dxp_plain(xp, kern, g, k, groups)
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    return _launch(KERNEL_DXP_GENERAL, False, (kern, g), xp.shape, n, h, w, c, k, groups)


def involution_bwd_dkern_general(xp: torch.Tensor, kern: torch.Tensor, g: torch.Tensor, k: int,
                                 groups: int) -> torch.Tensor:
    """:func:`involution_bwd_dkern` for any shape: on the card the general route's
    kernel (a warp-shuffle sum over each group's channels), on the CPU the plain
    version."""
    if g.device.type == "cpu" and xp.device.type == "cpu":
        return involution_bwd_dkern_plain(xp, kern, g, k, groups)
    n, h, w, c = _check_grad(xp, kern, g, k, groups)
    return _launch(KERNEL_DKERN_GENERAL, False, (xp, g), kern.shape, n, h, w, c, k, groups)


class InvolutionStencil(torch.autograd.Function):
    """:func:`involution_stencil` with its gradients for ``xp`` and ``kern``
    (``involution_stencil_ad``, ``holocron_tpu/kernels/involution.py:90-120``). All
    three take the kernels of the route :func:`bwd_route` picks on the card and the
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, xp: torch.Tensor, kern: torch.Tensor, k: int, groups: int) -> torch.Tensor:
        ctx.save_for_backward(xp, kern)
        ctx.k, ctx.groups = k, groups
        return involution_stencil(xp, kern, k, groups)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xp, kern = ctx.saved_tensors
        g = g.contiguous()
        if bwd_route(xp.shape[-1], ctx.groups, g.dtype) == "tiled":
            dxp_fn, dkern_fn = involution_bwd_dxp, involution_bwd_dkern
        else:
            dxp_fn, dkern_fn = involution_bwd_dxp_general, involution_bwd_dkern_general
        dxp = dxp_fn(xp, kern, g, ctx.k, ctx.groups) if ctx.needs_input_grad[0] else None
        dkern = dkern_fn(xp, kern, g, ctx.k, ctx.groups) if ctx.needs_input_grad[1] else None
        return dxp, dkern, None, None


# the JAX package's name for the differentiable form
involution_stencil_ad = InvolutionStencil.apply
