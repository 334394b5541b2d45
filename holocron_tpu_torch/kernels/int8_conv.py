"""The int8 convolution of ``holocron_tpu/quant.py:_quantized_conv`` (``quant.py:228-274``),
which the JAX package leaves to XLA: activation quantization, then int8 x int8 -> int32
convolution with the float requantize epilogue.

Layouts are the JAX package's: NHWC activations and int8 HWIO weights; the result is
NHWC. A quantized activation ``x_q`` keeps its logical shape ``(..., C)`` but lies at a
pixel pitch of :func:`channel_pitch` ``(C)``, C rounded up to whole 16-byte copies, with
channels C .. pitch - 1 zero: the view ``x_q[..., :C]`` of a ``(..., pitch)`` buffer,
the buffer itself where C % 16 == 0. On CUDA tensors the wrappers launch one of two
routes, chosen by shape in :func:`conv_route`:

- ``"wgmma"`` (``csrc/int8_conv.cu``, counter ``int8_conv``): every ungrouped conv. It
  reads x_q at its pitch and the weights packed once per layer over the same pitch by
  :func:`pack_weights`, so the reduction runs over KH * KW * pitch and the zeros add
  nothing; its quantization prologue has the counter ``int8_quantize``. Its indices are
  32-bit: a batch whose x reaches 2^31 elements (with an image of margin) runs as
  several launches of whole images within the one call, which counts once.
- ``"general"`` (``csrc/int8_conv_general.cu``, counter ``int8_conv_general``): every
  grouped conv, one GEMM a group.

On CPU tensors they compute the plain versions: :func:`quantize_activation_plain` (the
same pitched layout), and a float64 convolution over the integer-valued tensors, which
is exact (every partial sum is an integer far below 2**53), followed by the same
epilogue in float32.

:func:`quantize_activation` and :func:`int8_conv` go through two ``torch.library``
ops, ``holocron_tpu_torch::int8_quantize`` and ``holocron_tpu_torch::int8_conv``, whose
CUDA implementations launch the kernels and whose CPU implementations are the plain
versions. A ctypes call is opaque to ``torch.export``; an op with a fake
implementation (the output's shape and dtype) is traced as one node, so an exported int8
model holds the ops and runs the kernels the served model runs. The ops return fresh,
contiguous tensors: the quantization its whole ``(..., pitch)`` buffer, of which the
wrapper returns the view.
"""

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
from torch.nn import functional as F

from ._build import Kernel

__all__ = [
    "KERNEL",
    "KERNEL_GENERAL",
    "KERNEL_QUANTIZE",
    "STEP_K",
    "TILE_M",
    "TILE_N",
    "channel_pitch",
    "conv_route",
    "int8_conv",
    "int8_conv_acc",
    "int8_conv_acc_plain",
    "int8_conv_plain",
    "launch_tile_n",
    "pack_weights",
    "quantize_activation",
    "quantize_activation_plain",
    "quantized_conv",
    "tile_n",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV_ARGS = [_P, _P, _P, _P, _P, _I, _P, _I] + [_I] * 15
KERNEL = Kernel("int8_conv", "int8_conv_wgmma_forward", _CONV_ARGS + [_I, _I, _P])
KERNEL_GENERAL = Kernel("int8_conv_general", "int8_conv_forward", _CONV_ARGS + [_I] * 3 + [_P])
KERNEL_QUANTIZE = Kernel("int8_conv", "int8_quantize_forward", [_P, _P, _P, _I, ctypes.c_longlong, _I, _P])
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
QINT_MAX = 127.0

# wgmma column tiles the kernel is built for, its rows a tile, and its reduction step in bytes
TILE_N = (48, 64, 96, 128, 192, 256)
TILE_M = 128
STEP_K = 128

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def channel_pitch(c: int) -> int:
    """The pixel pitch of a quantized activation of ``c`` channels: ``c`` rounded up to
    whole 16-byte copies."""
    return -(-c // 16) * 16


def conv_route(c: int, o: int, groups: int = 1) -> str:
    """The route a CUDA int8 conv with ``c`` input channels a group, ``o`` output
    channels and ``groups`` groups takes: ``"wgmma"`` for every ungrouped conv (any C,
    read at its 16-byte pitch; any O, under a masked epilogue), ``"general"`` for a
    grouped one."""
    return "wgmma" if groups == 1 else "general"


def tile_n(o: int) -> int:
    """The wgmma route's column tile: the layer's whole O rounded up to a built width,
    or 256-wide tiles beyond 256."""
    return next((n for n in TILE_N if n >= o), TILE_N[-1])


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_tile_n(o: int, m: int, sms: int) -> int:
    """The column tile the wgmma route launches with at M = ``m`` output pixels on a
    card of ``sms`` SMs: :func:`tile_n`, except that a layer with fewer 256-wide tiles
    than SMs (an SE excitation, M = the batch) takes 64-wide ones, which spread its
    epilogue over more SMs; the packed rows (whole 256-wide tiles) hold them too."""
    bn = tile_n(o)
    return 64 if o > TILE_N[-1] and -(-m // TILE_M) * -(-o // bn) < sms else bn


def pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO int8 weights as the wgmma route reads them: an (O_pad, K_pad) K-major matrix
    over the activation's pitch ``P = channel_pitch(C)``, row o holding
    ``w_q[r, s, c, o]`` at ``(r * KW + s) * P + c``, zero at channels C .. P - 1 of each
    tap, beyond O (whole column tiles) and beyond K (whole 128-byte steps). Where
    C % 16 == 0, P = C."""
    kh, kw, c, o = w_q.shape
    pitch = channel_pitch(c)
    packed = w_q.new_zeros(_packed_shape(kh, kw, pitch, o))
    taps = packed[:o, : kh * kw * pitch].view(o, kh * kw, pitch)
    taps[:, :, :c] = w_q.permute(3, 0, 1, 2).reshape(o, kh * kw, c)
    return packed


def _packed_shape(kh: int, kw: int, c: int, o: int) -> Tuple[int, int]:
    bn = tile_n(o)
    return -(-o // bn) * bn, -(-kh * kw * c // STEP_K) * STEP_K


def _geometry(x_q: torch.Tensor, w_q: torch.Tensor, stride: IntPair, padding: IntPair, dilation: IntPair,
              groups: int = 1):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"expected int8 x_q and w_q, got {x_q.dtype} and {w_q.dtype}")
    if x_q.ndim != 4 or w_q.ndim != 4 or x_q.shape[-1] != w_q.shape[2] * groups or w_q.shape[3] % groups:
        raise ValueError(f"expected NHWC x_q and HWIO w_q with C = I * groups and O divisible by groups = {groups}, "
                         f"got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    n, h, w, _ = x_q.shape
    kh, kw, _, _ = w_q.shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    return (sh, sw), (ph, pw), (dh, dw), oh, ow


def _pitched_view(q: torch.Tensor, c: int) -> torch.Tensor:
    return q if q.shape[-1] == c else q[..., :c]


def _quantize_pitched_plain(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    q = torch.round(x.float() / s_x).clamp_(-QINT_MAX, QINT_MAX).to(torch.int8)
    c = q.shape[-1]
    return F.pad(q, (0, channel_pitch(c) - c))


def quantize_activation_plain(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s_x), -127, 127)`` as int8 (``quant.py:237-244``) at the pitched
    layout (:func:`channel_pitch` of the last dimension, zero beyond it); torch.round
    rounds half to even, as jnp.round does."""
    return _pitched_view(_quantize_pitched_plain(x, s_x), x.shape[-1])


# The ops' library: their schemas, a CUDA implementation (the kernel) and a CPU one (the
# plain version) each, and fake implementations (shape and dtype) for tracing. Defined
# with ``Library.define`` and ``impl``, not ``custom_op``, whose autograd and dispatch
# wrappers cost a multiple of the host time of a call (the ops are for inference: no
# autograd kernel is registered).
_LIB = torch.library.Library("holocron_tpu_torch", "DEF")
_LIB.define("int8_quantize(Tensor x, Tensor s_x) -> Tensor")
_LIB.define("int8_conv(Tensor x_q, Tensor w_q, Tensor s_x, Tensor w_scale, Tensor? bias, int[] stride, "
            "int[] padding, int[] dilation, int groups, ScalarType out_dtype, Tensor? w_packed) -> Tensor")


def _int8_quantize_cpu(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    return _quantize_pitched_plain(x, s_x)


@torch.library.register_fake("holocron_tpu_torch::int8_quantize")
def _int8_quantize_fake(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((*x.shape[:-1], channel_pitch(x.shape[-1])), dtype=torch.int8)


def quantize_activation(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """:func:`quantize_activation_plain`, by the ``int8_quantize`` kernel for a CUDA
    ``x`` (float32 or bfloat16, any shape; its last dimension is the channels, the
    result lies at their pitch), through ``holocron_tpu_torch::int8_quantize``."""
    return _pitched_view(torch.ops.holocron_tpu_torch.int8_quantize(x, s_x), x.shape[-1])


def _quantize_launch(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """The quantized ``x`` as its whole ``(..., channel_pitch(C))`` buffer: the
    ``int8_quantize`` kernel on the card."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the quantize kernel takes float32 or bfloat16, got {x.dtype}")
    if s_x.device != x.device or s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise ValueError("s_x must be a float32 scalar tensor on x's device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    c = x.shape[-1]
    q = torch.empty((*x.shape[:-1], channel_pitch(c)), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL_QUANTIZE(x.data_ptr(), s_x.data_ptr(), q.data_ptr(), int(x.dtype == torch.bfloat16), x.numel() // c, c,
                        torch.cuda.current_stream().cuda_stream)
    return q


def _at_pitch(x: torch.Tensor) -> torch.Tensor:
    """The NHWC int8 ``x`` at its pitch, as :func:`quantize_activation` lays it out: ``x``
    itself when it lies so (16-byte aligned), else a padded copy of a contiguous ``x``;
    raises for any other layout."""
    n, h, w, c = x.shape
    pitch = channel_pitch(c)
    if x.stride() == (h * w * pitch, w * pitch, pitch, 1) and x.data_ptr() % 16 == 0:
        return x
    if not x.is_contiguous():
        raise ValueError("x_q must be contiguous NHWC or at its channel pitch, as quantize_activation lays it out")
    return _pitched_view(F.pad(x, (0, pitch - c)), c)


def int8_conv_acc_plain(
    x_q: torch.Tensor, w_q: torch.Tensor, stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
    groups: int = 1,
) -> torch.Tensor:
    """The exact int32 accumulator, NHWC, from a float64 convolution (``w_q`` is
    ``(KH, KW, C / groups, O)``, as ``feature_group_count`` takes it)."""
    _geometry(x_q, w_q, stride, padding, dilation, groups)
    acc = F.conv2d(
        x_q.permute(0, 3, 1, 2).double(), w_q.permute(3, 2, 0, 1).double(),
        stride=_pair(stride), padding=_pair(padding), dilation=_pair(dilation), groups=groups,
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
    groups: int = 1,
) -> torch.Tensor:
    """Plain version of :func:`int8_conv`."""
    return _epilogue(int8_conv_acc_plain(x_q, w_q, stride, padding, dilation, groups), s_x, w_scale, bias, out_dtype)


def _launch(x, w_q, w_packed, s_x, w_scale, bias, stride, padding, dilation, out_dtype, groups):
    """Launches the route :func:`conv_route` picks on the int8 NHWC ``x``."""
    (sh, sw), (ph, pw), (dh, dw), oh, ow = _geometry(x, w_q, stride, padding, dilation, groups)
    dev = x.device
    operands = [x, w_q] + ([] if out_dtype == torch.int32 else [s_x, w_scale]) + ([] if bias is None else [bias])
    if dev.type != "cuda" or any(t.device != dev for t in operands):
        raise ValueError("all operands of the int8 conv must lie on one CUDA device")
    if not w_q.is_contiguous():
        raise ValueError("w_q (HWIO) must be contiguous")
    x = _at_pitch(x)
    n, h, w, c = x.shape
    pitch = x.stride(2)
    kh, kw, _, o = w_q.shape
    s_ptr = ws_ptr = b_ptr = None
    bias_bf16 = 0
    if out_dtype != torch.int32:
        if s_x.dtype != torch.float32 or s_x.numel() != 1:
            raise ValueError("s_x must be a float32 scalar tensor")
        s_x = s_x.contiguous()
        s_ptr = s_x.data_ptr()
        if w_scale.dtype != torch.float32 or w_scale.shape != (o,):
            raise ValueError("w_scale must be a float32 (O,) tensor")
        if bias is not None and (bias.dtype not in (torch.float32, torch.bfloat16) or bias.shape != (o,)):
            raise ValueError("bias must be a float32 or bfloat16 (O,) tensor")
        w_scale = w_scale.contiguous()
        bias = None if bias is None else bias.contiguous()
        ws_ptr = w_scale.data_ptr()
        b_ptr = None if bias is None else bias.data_ptr()
        bias_bf16 = int(bias is not None and bias.dtype == torch.bfloat16)
    out = torch.empty((n, oh, ow, o), dtype=out_dtype, device=dev)
    geometry = (sh, sw, ph, pw, dh, dw, oh, ow)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if conv_route(w_q.shape[2], o, groups) == "wgmma":
            if w_packed is None:
                w_packed = pack_weights(w_q)
            if (w_packed.device != dev or w_packed.dtype != torch.int8 or not w_packed.is_contiguous()
                    or tuple(w_packed.shape) != _packed_shape(kh, kw, pitch, o)):
                raise ValueError(f"w_packed ({tuple(w_packed.shape)}, {w_packed.device}) is not pack_weights(w_q)")
            # the kernel reads x at its pitch: the reduction runs over the pitch's channels
            bn = launch_tile_n(o, n * oh * ow, _sm_count(torch.cuda.current_device()))
            KERNEL(x.data_ptr(), w_packed.data_ptr(), s_ptr, ws_ptr, b_ptr, bias_bf16, out.data_ptr(),
                   _OUT_CODES[out_dtype], n, h, w, pitch, o, kh, kw, *geometry, bn, w_packed.shape[1], stream)
        else:
            # the general kernel's fast staging path takes 16-channel runs of x and 4-channel
            # runs of w, in each group; else byte-wise staging
            cg, og = c // groups, o // groups
            fast = int(cg % 16 == 0 and og % 4 == 0 and w_q.data_ptr() % 4 == 0)
            if groups > 65535:
                raise ValueError(f"the general route takes at most 65535 groups, got {groups}")
            KERNEL_GENERAL(x.data_ptr(), w_q.data_ptr(), s_ptr, ws_ptr, b_ptr, bias_bf16, out.data_ptr(),
                           _OUT_CODES[out_dtype], n, h, w, c, o, kh, kw, *geometry, groups, pitch, fast, stream)
    return out


def int8_conv_acc(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
    w_packed: Optional[torch.Tensor] = None,
    groups: int = 1,
) -> torch.Tensor:
    """The int32 accumulator of the int8 conv, NHWC (no epilogue). ``x_q`` as
    :func:`int8_conv` takes it; ``w_packed``: :func:`pack_weights` of ``w_q``, made here
    when the wgmma route needs it and it is not given."""
    if x_q.device.type == "cpu" and w_q.device.type == "cpu":
        return int8_conv_acc_plain(x_q, w_q, stride, padding, dilation, groups)
    return _launch(x_q, w_q, w_packed, None, None, None, stride, padding, dilation, torch.int32, groups)


def _check_call(out_dtype: torch.dtype) -> None:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _int8_conv_cuda(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, groups, out_dtype, w_packed):
    """:func:`int8_conv` on the card: the route :func:`conv_route` picks."""
    return _launch(x_q, w_q, w_packed, s_x, w_scale, bias, stride, padding, dilation, out_dtype, groups)


def _int8_conv_cpu(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, groups, out_dtype, w_packed):
    return int8_conv_plain(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, out_dtype, groups).contiguous()


@torch.library.register_fake("holocron_tpu_torch::int8_conv")
def _int8_conv_fake(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, groups, out_dtype, w_packed):
    *_, oh, ow = _geometry(x_q, w_q, stride, padding, dilation, groups)
    return x_q.new_empty((x_q.shape[0], oh, ow, w_q.shape[3]), dtype=out_dtype)


_LIB.impl("int8_quantize", _quantize_launch, "CUDA")
_LIB.impl("int8_quantize", _int8_quantize_cpu, "CPU")
_LIB.impl("int8_conv", _int8_conv_cuda, "CUDA")
_LIB.impl("int8_conv", _int8_conv_cpu, "CPU")


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
    w_packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``float(conv(x_q, w_q)) * (s_x * w_scale) + bias`` in ``out_dtype``, NHWC.

    Args:
        x_q: int8 ``(N, H, W, C)`` at its channel pitch, as :func:`quantize_activation`
            lays it out, or contiguous (then padded to its pitch here, a layout copy
            where C % 16 != 0); w_q: int8 ``(KH, KW, C / groups, O)``
        s_x: float32 scalar tensor, the activation scale (abs-max / 127)
        w_scale: float32 ``(O,)``, the per-output-channel weight scales
        bias: optional ``(O,)``, float32 or bfloat16
        groups: ``feature_group_count``; a grouped conv takes the general route
        out_dtype: float32 or bfloat16
        w_packed: :func:`pack_weights` of ``w_q``, made here when the wgmma route needs
            it and it is not given
    """
    _check_call(out_dtype)
    return torch.ops.holocron_tpu_torch.int8_conv(x_q, w_q, s_x, w_scale, bias, list(_pair(stride)),
                                                  list(_pair(padding)), list(_pair(dilation)), groups, out_dtype,
                                                  w_packed)


def quantized_conv(
    x: torch.Tensor,
    s_x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
    out_dtype: torch.dtype = torch.float32,
    w_packed: Optional[torch.Tensor] = None,
    groups: int = 1,
) -> torch.Tensor:
    """``_quantized_conv`` (``quant.py:237-274``) on a float NHWC ``x``: quantized with
    ``s_x`` by :func:`quantize_activation`, then :func:`int8_conv`. On the card that is
    two launches; ``x`` is read in place when its NHWC view is contiguous (an NCHW
    tensor in channels_last)."""
    return int8_conv(quantize_activation(x, s_x), w_q, s_x, w_scale, bias, stride, padding, dilation, groups,
                     out_dtype=out_dtype, w_packed=w_packed)

