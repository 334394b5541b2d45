"""int8 x int8 -> int32 convolution with the float requantize epilogue: the port of
the int8 conv in ``holocron_tpu/quant.py:_quantized_conv`` (``quant.py:259-274``),
which the JAX package leaves to XLA.

Layouts are the JAX package's: int8 NHWC activations and int8 HWIO weights; the
result is NHWC. On CUDA tensors the wrappers launch ``csrc/int8_conv.cu``; on CPU
tensors they compute the plain versions, a float64 convolution over the
integer-valued tensors, which is exact (every partial sum is an integer far below
2**53), followed by the same epilogue in float32.
"""

import ctypes
from typing import Optional, Tuple, Union

import torch
from torch.nn import functional as F

from ._build import Kernel

__all__ = ["KERNEL", "int8_conv", "int8_conv_acc", "int8_conv_acc_plain", "int8_conv_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("int8_conv", "int8_conv_forward", [_P, _P, _P, _P, _P, _I, _P, _I] + [_I] * 16 + [_P])
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _geometry(x_q: torch.Tensor, w_q: torch.Tensor, stride: IntPair, padding: IntPair, dilation: IntPair):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"expected int8 x_q and w_q, got {x_q.dtype} and {w_q.dtype}")
    if x_q.ndim != 4 or w_q.ndim != 4 or x_q.shape[-1] != w_q.shape[2]:
        raise ValueError(f"expected NHWC x_q and HWIO w_q with matching C, got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    n, h, w, _ = x_q.shape
    kh, kw, _, _ = w_q.shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    return (sh, sw), (ph, pw), (dh, dw), oh, ow


def int8_conv_acc_plain(
    x_q: torch.Tensor, w_q: torch.Tensor, stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1
) -> torch.Tensor:
    """The exact int32 accumulator, NHWC, from a float64 convolution."""
    _geometry(x_q, w_q, stride, padding, dilation)
    acc = F.conv2d(
        x_q.permute(0, 3, 1, 2).double(), w_q.permute(3, 2, 0, 1).double(),
        stride=_pair(stride), padding=_pair(padding), dilation=_pair(dilation),
    )
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def _epilogue(acc: torch.Tensor, s_x: torch.Tensor, w_scale: torch.Tensor, bias: Optional[torch.Tensor], out_dtype):
    # quant.py:270-273: acc * (s_x * w_scale) + bias, in float32
    y = acc.float() * (s_x.float() * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_conv_plain(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    s_x: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of :func:`int8_conv`."""
    return _epilogue(int8_conv_acc_plain(x_q, w_q, stride, padding, dilation), s_x, w_scale, bias, out_dtype)


def _launch(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, out_dtype) -> torch.Tensor:
    (sh, sw), (ph, pw), (dh, dw), oh, ow = _geometry(x_q, w_q, stride, padding, dilation)
    dev = x_q.device
    operands = [x_q, w_q] + ([] if out_dtype == torch.int32 else [s_x, w_scale]) + ([] if bias is None else [bias])
    if dev.type != "cuda" or any(t.device != dev for t in operands):
        raise ValueError("all operands of the int8 conv must lie on one CUDA device")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("x_q (NHWC) and w_q (HWIO) must be contiguous")
    n, h, w, c = x_q.shape
    kh, kw, _, o = w_q.shape
    if out_dtype == torch.int32:
        s_ptr = ws_ptr = b_ptr = None
        bias_bf16 = 0
    else:
        if s_x.dtype != torch.float32 or s_x.numel() != 1 or w_scale.dtype != torch.float32 or w_scale.shape != (o,):
            raise ValueError("s_x must be a float32 scalar tensor and w_scale a float32 (O,) tensor")
        if bias is not None and (bias.dtype not in (torch.float32, torch.bfloat16) or bias.shape != (o,)):
            raise ValueError("bias must be a float32 or bfloat16 (O,) tensor")
        s_x, w_scale = s_x.contiguous(), w_scale.contiguous()
        bias = None if bias is None else bias.contiguous()
        s_ptr, ws_ptr = s_x.data_ptr(), w_scale.data_ptr()
        b_ptr = None if bias is None else bias.data_ptr()
        bias_bf16 = int(bias is not None and bias.dtype == torch.bfloat16)
    out = torch.empty((n, oh, ow, o), dtype=out_dtype, device=dev)
    # the kernel's fast staging path takes 16-channel runs of x and 4-channel runs of w
    fast = int(c % 16 == 0 and o % 4 == 0 and x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 4 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL(
            x_q.data_ptr(), w_q.data_ptr(), s_ptr, ws_ptr, b_ptr, bias_bf16, out.data_ptr(), _OUT_CODES[out_dtype],
            n, h, w, c, o, kh, kw, sh, sw, ph, pw, dh, dw, oh, ow, fast, stream,
        )
    return out


def int8_conv_acc(
    x_q: torch.Tensor, w_q: torch.Tensor, stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1
) -> torch.Tensor:
    """The int32 accumulator of the int8 conv, NHWC (no epilogue)."""
    if x_q.device.type == "cpu" and w_q.device.type == "cpu":
        return int8_conv_acc_plain(x_q, w_q, stride, padding, dilation)
    return _launch(x_q, w_q, None, None, None, stride, padding, dilation, torch.int32)


def int8_conv(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    s_x: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
    groups: int = 1,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``float(conv(x_q, w_q)) * (s_x * w_scale) + bias`` in ``out_dtype``, NHWC.

    Args:
        x_q: int8 ``(N, H, W, C)``; w_q: int8 ``(KH, KW, C, O)``
        s_x: float32 scalar tensor, the activation scale (abs-max / 127)
        w_scale: float32 ``(O,)``, the per-output-channel weight scales
        bias: optional ``(O,)``, float32 or bfloat16
        groups: must be 1 (the kernel has no grouped form yet)
        out_dtype: float32 or bfloat16
    """
    if groups != 1:
        raise NotImplementedError("the int8 conv kernel supports groups=1 only")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x_q.device.type == "cpu" and w_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, out_dtype)
    return _launch(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, out_dtype)
