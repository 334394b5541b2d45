"""Involution stencil: the port of ``holocron_tpu/kernels/involution.py``.

``out[n, h, w, c] = sum_{tap=(dy, dx)} kern[n, h, w, tap * G + c // (C / G)] * xp[n, h + dy, w + dx, c]``
for stride 1 and dilation 1, accumulated in float32 and stored in ``xp``'s dtype.
Layouts are the JAX package's: NHWC pre-padded ``xp`` and a tap-major kernel field.

On a CUDA tensor :func:`involution_stencil` launches ``csrc/involution.cu`` (the
forward; the backward waits for the training slice). On a CPU tensor it computes
:func:`involution_stencil_plain`, the per-tap sum that the tests hold both against.
"""

import ctypes

import torch

from ._build import Kernel

__all__ = ["KERNEL", "involution_stencil", "involution_stencil_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("involution", "involution_forward", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if xp.device.type != "cuda" or kern.device != xp.device:
        raise ValueError(f"xp and kern must lie on one CUDA device, got {xp.device} and {kern.device}")
    if xp.dtype not in _DTYPES or kern.dtype != xp.dtype:
        raise TypeError(f"expected float32 or bfloat16 xp and kern of one dtype, got {xp.dtype} and {kern.dtype}")
    xp, kern = xp.contiguous(), kern.contiguous()
    out = torch.empty((n, h, w, c), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(xp.data_ptr(), kern.data_ptr(), out.data_ptr(), _DTYPES[xp.dtype], n, h, w, c, groups, k, stream)
    return out
