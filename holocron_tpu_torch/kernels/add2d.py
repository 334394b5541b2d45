"""AdderNet "matmul": the port of ``holocron_tpu/kernels/add2d.py``.

``out[l, o] = -sum_d |p[l, d] - w[d, o]|`` for ``p (L, D)`` and ``w (D, O)``, accumulated
in float32 and stored in ``p``'s dtype (float32 or bfloat16). Its gradients, for the
cotangent ``g (L, O)``, are ``dp[l, d] = -sum_o g[l, o] * sign(p[l, d] - w[d, o])`` (in
``p``'s dtype) and ``dw[d, o] = sum_l g[l, o] * sign(p[l, d] - w[d, o])`` (in ``w``'s).

On a CUDA tensor :func:`add2d_matmul`, :func:`add2d_bwd_dp` and :func:`add2d_bwd_dw`
launch the three kernels of ``csrc/add2d.cu``; on a CPU tensor each computes its plain
version (``*_plain``), which never materializes the ``(L, D, O)`` broadcast whole: the
forward and the backward go over chunks of O of at most ``1 << 23`` broadcast
elements, as ``_add2d_bwd`` does. :class:`Add2dMatmul` (``add2d_matmul_ad``, as the JAX
package names it) is the differentiable form.
"""

import ctypes
import math
from typing import Tuple

import torch

from ._build import FLOAT_DTYPES, Kernel, cuda_operands

__all__ = [
    "KERNEL_BWD_DP",
    "KERNEL_BWD_DW",
    "KERNEL_FWD",
    "Add2dMatmul",
    "add2d_bwd_dp",
    "add2d_bwd_dp_plain",
    "add2d_bwd_dw",
    "add2d_bwd_dw_plain",
    "add2d_matmul",
    "add2d_matmul_ad",
    "add2d_matmul_plain",
    "dw_slices",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL_FWD = Kernel("add2d", "add2d_forward", [_P, _P, _P, _I, _I, _I, _I, _P])
KERNEL_BWD_DP = Kernel("add2d", "add2d_backward_dp", [_P, _P, _P, _P, _I, _I, _I, _I, _P])
KERNEL_BWD_DW = Kernel("add2d", "add2d_backward_dw", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
_BUDGET = 1 << 23  # broadcast elements per chunk of the plain versions (add2d.py:92)
_TILE = 64  # output tile edge of the kernels
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
_MIN_ROWS = 256  # fewest rows of L a dw slice reduces


def _check(p: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int]:
    if p.ndim != 2 or w.ndim != 2 or p.shape[1] != w.shape[0]:
        raise ValueError(f"expected p (L, D) and w (D, O), got {tuple(p.shape)} and {tuple(w.shape)}")
    return p.shape[0], p.shape[1], w.shape[1]


def _check_grad(p: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> Tuple[int, int, int]:
    l, d, o = _check(p, w)
    if tuple(g.shape) != (l, o):
        raise ValueError(f"g shape {tuple(g.shape)} != {(l, o)}")
    return l, d, o


def _chunk(l: int, d: int, o: int) -> int:
    return int(min(o, max(1, _BUDGET // max(l * d, 1))))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def add2d_matmul_plain(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The broadcast ``-sum_d |p - w|`` in float32 over chunks of O, cast to ``p``'s dtype."""
    l, d, o = _check(p, w)
    pf, wf = p.float(), w.float()
    step = _chunk(l, d, o)
    out = torch.empty((l, o), dtype=torch.float32, device=p.device)
    for start in range(0, o, step):
        out[:, start : start + step] = -(pf[:, :, None] - wf[None, :, start : start + step]).abs().sum(1)
    return out.to(p.dtype)


def add2d_bwd_dp_plain(p: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dp = -sum_o g * sign(p - w)`` over chunks of O (``_add2d_bwd``), float32, cast
    to ``p``'s dtype."""
    l, d, o = _check_grad(p, w, g)
    pf, wf, gf = p.float(), w.float(), g.float()
    step = _chunk(l, d, o)
    dp = torch.zeros((l, d), dtype=torch.float32, device=p.device)
    for start in range(0, o, step):
        sign = torch.sign(pf[:, :, None] - wf[None, :, start : start + step])
        dp -= torch.einsum("lc,ldc->ld", gf[:, start : start + step], sign)
    return dp.to(p.dtype)


def add2d_bwd_dw_plain(p: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw = sum_l g * sign(p - w)`` over chunks of O (``_add2d_bwd``), float32, cast
    to ``w``'s dtype."""
    l, d, o = _check_grad(p, w, g)
    pf, wf, gf = p.float(), w.float(), g.float()
    step = _chunk(l, d, o)
    dw = torch.empty((d, o), dtype=torch.float32, device=p.device)
    for start in range(0, o, step):
        sign = torch.sign(pf[:, :, None] - wf[None, :, start : start + step])
        dw[:, start : start + step] = torch.einsum("lc,ldc->dc", gf[:, start : start + step], sign)
    return dw.to(w.dtype)


def add2d_matmul(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[l, o] = -sum_d |p[l, d] - w[d, o]|``: the kernel on the card, the plain
    version on the CPU."""
    if p.device.type == "cpu" and w.device.type == "cpu":
        return add2d_matmul_plain(p, w)
    l, d, o = _check(p, w)
    p, w = cuda_operands(p, w)
    out = torch.empty((l, o), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        KERNEL_FWD(p.data_ptr(), w.data_ptr(), out.data_ptr(), FLOAT_DTYPES[p.dtype], l, d, o, _stream(p.device))
    return out


def add2d_bwd_dp(p: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`add2d_matmul` for ``p``: the kernel on the card (output
    tiles over ``(l, d)``, O reduced in the block), the plain version on the CPU."""
    if p.device.type == "cpu" and w.device.type == "cpu" and g.device.type == "cpu":
        return add2d_bwd_dp_plain(p, w, g)
    l, d, o = _check_grad(p, w, g)
    p, w, g = cuda_operands(p, w, g)
    dp = torch.empty((l, d), dtype=p.dtype, device=p.device)
    with torch.cuda.device(p.device):
        KERNEL_BWD_DP(p.data_ptr(), w.data_ptr(), g.data_ptr(), dp.data_ptr(), FLOAT_DTYPES[p.dtype], l, d, o,
                      _stream(p.device))
    return dp


def dw_slices(l: int, d: int, o: int) -> Tuple[int, int]:
    """``(slices, rows)``: how the dw kernel splits L over blocks, enough slices for
    about two blocks an SM, none shorter than 256 rows."""
    tiles = math.ceil(d / _TILE) * math.ceil(o / _TILE)
    slices = max(1, min(math.ceil(l / _MIN_ROWS), math.ceil(_TARGET_BLOCKS / max(tiles, 1))))
    rows = max(1, math.ceil(l / slices))
    return math.ceil(l / rows) if l else 1, rows


def add2d_bwd_dw(p: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`add2d_matmul` for ``w``: on the card, float32 partial sums
    over slices of L (:func:`dw_slices`) added in slice order by a second pass, so the
    result does not change from run to run; the plain version on the CPU."""
    if p.device.type == "cpu" and w.device.type == "cpu" and g.device.type == "cpu":
        return add2d_bwd_dw_plain(p, w, g)
    l, d, o = _check_grad(p, w, g)
    p, w, g = cuda_operands(p, w, g)
    slices, rows = dw_slices(l, d, o)
    partial = torch.empty((slices, d, o), dtype=torch.float32, device=p.device)
    dw = torch.empty((d, o), dtype=w.dtype, device=p.device)
    with torch.cuda.device(p.device):
        KERNEL_BWD_DW(p.data_ptr(), w.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                      FLOAT_DTYPES[p.dtype], l, d, o, slices, rows, _stream(p.device))
    return dw


class Add2dMatmul(torch.autograd.Function):
    """:func:`add2d_matmul` with its gradients (``add2d_matmul_ad``,
    ``holocron_tpu/kernels/add2d.py:72-111``): three kernels on the card, the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(p, w)
        return add2d_matmul(p, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        p, w = ctx.saved_tensors
        g = g.contiguous()
        dp = add2d_bwd_dp(p, w, g) if ctx.needs_input_grad[0] else None
        dw = add2d_bwd_dw(p, w, g) if ctx.needs_input_grad[1] else None
        return dp, dw


# the JAX package's name for the differentiable form
add2d_matmul_ad = Add2dMatmul.apply
