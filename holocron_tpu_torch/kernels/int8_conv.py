"""The int8 convolution of ``holocron_tpu/quant.py:_quantized_conv`` (``quant.py:228-274``),
which the JAX package leaves to XLA: activation quantization, then int8 x int8 -> int32
convolution with the float requantize epilogue.

Layouts are the JAX package's: NHWC activations and int8 HWIO weights; the result is
NHWC. A quantized activation ``x_q`` keeps its logical shape ``(..., C)`` but lies at a
pixel pitch of :func:`channel_pitch` ``(C)``, C rounded up to whole 16-byte copies, with
channels C .. pitch - 1 zero: the view ``x_q[..., :C]`` of a ``(..., pitch)`` buffer,
the buffer itself where C % 16 == 0. On CUDA tensors the wrappers launch one of four
routes, chosen by shape and launch size in :func:`conv_route`:

- ``"pointwise"`` (``csrc/int8_conv.cu``'s ``int8_pointwise_wgmma_kernel``, counter
  ``int8_pointwise``): every 1x1, stride-1, unpadded, ungrouped conv, a GEMM over the
  pixels fed by TMA, in column tiles of :func:`pointwise_launch_tile_n`. Its rows run
  in launches of 2^30 within the one call, which counts once.
- ``"halo"`` (``csrc/int8_conv.cu``'s ``int8_conv_halo_kernel``, counter
  ``int8_conv_halo``): the ungrouped KxK convs (2 to 64 taps, any padding) of stride
  1 and dilation 1 whose O is a multiple of 8 (a row of y whole 16-byte pieces in every
  output dtype) and whose C is at most 48, launched on at least :data:`HALO_MIN_ROWS`
  output pixels (:func:`conv_route` says why). Each tile's
  input halo is copied once into shared memory (zero-filled outside the image: the
  padding) and every filter tap reads it there, shifted, so an activation byte crosses
  L2 about 1.3 to 2 times instead of once per tap (``holocron_tpu/quant.py:259-274``,
  which the JAX package leaves to XLA). It reads the same packed weights as the wgmma
  route, in column tiles of :func:`halo_tile_n`, through a tensor map; its offsets are
  64-bit, so any batch is one launch. Its bound on an H100 at the layers it takes is
  the bytes (x read and y written once).
- ``"wgmma"`` (``csrc/int8_conv.cu``, counter ``int8_conv``): every other ungrouped
  conv (strided, dilated, O % 8 != 0, C > 48, or a smaller launch). It reads x_q at its
  pitch and the weights
  packed once per layer over the same pitch by :func:`pack_weights`, so the reduction
  runs over KH * KW * pitch and the zeros add nothing; its quantization prologue has the
  counter ``int8_quantize``. Its indices are 32-bit: a batch whose x reaches 2^31
  elements (with an image of margin) runs as several launches of whole images within
  the one call, which counts once.
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
    "KERNEL_HALO",
    "KERNEL_POINTWISE",
    "KERNEL_QUANTIZE",
    "STEP_K",
    "TILE_M",
    "TILE_N",
    "channel_pitch",
    "conv_route",
    "halo_takes",
    "halo_tile_n",
    "int8_conv",
    "int8_conv_acc",
    "int8_conv_acc_plain",
    "int8_conv_plain",
    "launch_tile_n",
    "pack_weights",
    "pointwise_launch_tile_n",
    "pointwise_tile_n",
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
KERNEL_POINTWISE = Kernel("int8_conv", "int8_pointwise_forward",
                          [_P, _P, _P, _P, _P, _I, _P, _I, ctypes.c_longlong] + [_I] * 5 + [_P])
KERNEL_HALO = Kernel("int8_conv", "int8_conv_halo_forward", [_P, _P, _P, _P, _P, _I, _P, _I] + [_I] * 12 + [_P])
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
QINT_MAX = 127.0

# wgmma column tiles the kernel is built for, its rows a tile, and its reduction step in bytes
TILE_N = (48, 64, 96, 128, 192, 256)
TILE_M = 128
STEP_K = 128
# the pointwise route's column tiles where O spans several: multiples of 64 columns
POINTWISE_WIDE = (64, 128, 192, 256)
# the halo route's column tiles (a warpgroup holds 4 chunks of 64 rows at 48 and 64
# columns, 2 at 96 and 128: at most 128 accumulator registers), its most taps, and the
# most input channels and fewest output pixels a launch of conv_route's gives it
HALO_TILE_N = (48, 64, 96, 128)
HALO_MAX_TAPS = 64
HALO_MAX_C = 48
HALO_MIN_ROWS = 401408

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def channel_pitch(c: int) -> int:
    """The pixel pitch of a quantized activation of ``c`` channels: ``c`` rounded up to
    whole 16-byte copies."""
    return -(-c // 16) * 16


def halo_takes(c: int, o: int, groups: int = 1, *, kernel_size: IntPair, stride: IntPair = 1,
               dilation: IntPair = 1) -> bool:
    """Whether the halo kernel takes the conv: ungrouped, KxK (2 to 64 taps, any
    padding), stride 1, dilation 1, ``o`` a multiple of 8 (a row of y whole 16-byte
    pieces in every output dtype), any C."""
    kh, kw = _pair(kernel_size)
    return (groups == 1 and _pair(stride) == (1, 1) and _pair(dilation) == (1, 1)
            and 2 <= kh * kw <= HALO_MAX_TAPS and o % 8 == 0)


def conv_route(c: int, o: int, groups: int = 1, *, kernel_size: IntPair, stride: IntPair = 1,
               padding: IntPair = 0, dilation: IntPair = 1, rows: Optional[int] = None) -> str:
    """The route a CUDA int8 conv with ``c`` input channels a group, ``o`` output
    channels, ``groups`` groups and the given geometry takes, launched on ``rows``
    output pixels (N * OH * OW; None: a launch of at least :data:`HALO_MIN_ROWS`, the
    layer's route as ``QuantizedConv2d.route`` gives it):
    ``"general"`` for a grouped conv; ``"pointwise"`` for a 1x1, stride-1, unpadded one
    (any C, read at its 16-byte pitch; any O: its epilogue stores rows of y that are
    whole 16-byte pieces by the tensor map, the rows of an O of at most 192 as
    contiguous runs, and other widths copied out by the threads; a 1x1 kernel's
    dilation changes nothing); ``"halo"`` for a conv :func:`halo_takes` with at most
    :data:`HALO_MAX_C` (48) input channels on at least :data:`HALO_MIN_ROWS` (401,408)
    output pixels; ``"wgmma"`` for every other (strided, dilated, O % 8 != 0, C > 48,
    or a smaller launch: any C and O, under a masked epilogue).

    The channel rule (``chip_smoke.py``'s ``check_int8_geometry`` rows, NVIDIA H100,
    PERF.md): the halo kernel computes the padded image's columns (W + 2 of every W) and
    whole 64-row chunks. That costs little on large maps, where it beats the wgmma route
    (48 -> 48 at 112 px, batch 256: 0.38 ms against 0.52), and up to a third more
    products on small ones, where it loses (192 -> 192 at 14 px: 0.053 against 0.049;
    512 -> 512 at 7: 0.19 against 0.075). The rule sees no map size: the served 64 ->
    64 convs run faster on it at 56 px and more (resnet50 at 56, batch 256: 0.12 against
    0.16) and slower on unet3p's 32 and 64 px maps at batch 32 (0.015 against 0.010, 0.031
    against 0.030), so C = 64 stays on wgmma.

    The launch rule (``bench_int8_routes.py``, NVIDIA H100, PERF.md): a halo tile waits
    for its whole halo and weights before its first product, a latency the wgmma
    route's per-step ring hides, and likely most of a small launch's time. At 48 -> 48
    the halo conv loses at 56 px, batch 1 and 8 (25,088 pixels: 0.0119-0.0121 ms against
    0.0080-0.0081), and at 112 px, batch 1 (0.0119 against 0.0063). At 100,352 pixels it
    wins alone by 0.4-1.1 us (112 px at batch 8, 56 px at batch 32), but inside a
    forward a halo launch costs some 3-4 us more than alone: repvgg_a0's batch-8 forward
    ran 4-8 us slower with its one. From 401,408 pixels (112 px at batch 32: 0.0578
    against 0.0710) the gain exceeds that. Tiles of 2 chunks at small launches narrowed
    the loss to 11-26% and did not close it."""
    if groups != 1:
        return "general"
    kh, kw = _pair(kernel_size)
    unit = _pair(stride) == (1, 1)
    if (kh, kw) == (1, 1) and unit and _pair(padding) == (0, 0):
        return "pointwise"
    if (c <= HALO_MAX_C and (rows is None or rows >= HALO_MIN_ROWS)
            and halo_takes(c, o, kernel_size=(kh, kw), stride=stride, dilation=dilation)):
        return "halo"
    return "wgmma"


def halo_tile_n(o: int) -> int:
    """The halo route's column tile: the width of :data:`HALO_TILE_N` that pads O least,
    the widest of those that tie (48 -> 48, 192 -> 96, 256 -> 128, 320 -> 64,
    1280 -> 128)."""
    return min(HALO_TILE_N, key=lambda n: (-(-o // n) * n, -n))


def tile_n(o: int) -> int:
    """The wgmma route's column tile: the layer's whole O rounded up to a built width,
    or 256-wide tiles beyond 256."""
    return next((n for n in TILE_N if n >= o), TILE_N[-1])


def pointwise_tile_n(o: int) -> int:
    """The pointwise route's column tile: one tile of :func:`tile_n` where O fits one
    (O <= 256), else the width of :data:`POINTWISE_WIDE` that pads O least, the widest
    of those that tie (384 -> 192, 320 -> 64, 640 -> 128, 1280 -> 256). Those widths are
    whole 128-byte store chunks in every output dtype, so no chunk reaches into the next
    tile."""
    if o <= TILE_N[-1]:
        return tile_n(o)
    return min(POINTWISE_WIDE, key=lambda n: (-(-o // n) * n, -n))


def pointwise_launch_tile_n(o: int, m: int, sms: int) -> int:
    """The column tile the pointwise route launches with at M = ``m`` rows on a card of
    ``sms`` SMs: :func:`pointwise_tile_n`, except that a layer of several column tiles
    with fewer 64-row tiles than SMs (an SE excitation, M = the batch) takes 64-wide
    ones, which spread it over more SMs."""
    bn = pointwise_tile_n(o)
    return 64 if o > TILE_N[-1] and -(-m // 64) * -(-o // bn) < sms else bn


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


def _launch(x, w_q, w_packed, s_x, w_scale, bias, stride, padding, dilation, out_dtype, groups, route=None):
    """Launches the route :func:`conv_route` picks on the int8 NHWC ``x``, or ``route``
    where given: ``"wgmma"`` takes any ungrouped conv and ``"halo"`` any that
    :func:`halo_takes` (the checks time each beside the route picked, on the same
    operands). Every route but the general one reads ``w_packed``, :func:`pack_weights`
    of ``w_q`` (None packs it here)."""
    (sh, sw), (ph, pw), (dh, dw), oh, ow = _geometry(x, w_q, stride, padding, dilation, groups)
    c, o = w_q.shape[2], w_q.shape[3]
    picked = conv_route(c, o, groups, kernel_size=w_q.shape[:2], stride=(sh, sw), padding=(ph, pw),
                        dilation=(dh, dw), rows=x.shape[0] * oh * ow)
    forced_ok = ((route == "wgmma" and picked in ("pointwise", "halo"))
                 or (route == "halo" and halo_takes(c, o, groups, kernel_size=w_q.shape[:2], stride=(sh, sw),
                                                    dilation=(dh, dw))))
    if route not in (None, picked) and not forced_ok:
        raise ValueError(f"the {route} route does not take this conv (conv_route picks {picked})")
    route = route or picked
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
        if route != "general":
            if w_packed is None:
                w_packed = pack_weights(w_q)
            if (w_packed.device != dev or w_packed.dtype != torch.int8 or not w_packed.is_contiguous()
                    or tuple(w_packed.shape) != _packed_shape(kh, kw, pitch, o)):
                raise ValueError(f"w_packed ({tuple(w_packed.shape)}, {w_packed.device}) is not pack_weights(w_q)")
        if route == "pointwise":
            # x at its pitch is an (N * H * W, pitch) matrix; a column tile reads the
            # packed rows past O as zeros, and past the packed matrix zeros too (the
            # tensor map's bounds), so any launch width reads the one packing
            KERNEL_POINTWISE(x.data_ptr(), w_packed.data_ptr(), s_ptr, ws_ptr, b_ptr, bias_bf16, out.data_ptr(),
                             _OUT_CODES[out_dtype], n * h * w, pitch, o,
                             pointwise_launch_tile_n(o, n * h * w, _sm_count(torch.cuda.current_device())),
                             w_packed.shape[0], w_packed.shape[1], stream)
        elif route == "halo":
            # the kernel copies x's halo rows at its pitch with cp.async, the packed weights by TMA
            KERNEL_HALO(x.data_ptr(), w_packed.data_ptr(), s_ptr, ws_ptr, b_ptr, bias_bf16, out.data_ptr(),
                        _OUT_CODES[out_dtype], n, h, w, pitch, o, kh, kw, ph, pw, halo_tile_n(o), w_packed.shape[0],
                        w_packed.shape[1], stream)
        elif route == "wgmma":
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
    when the wgmma, halo or pointwise route needs it and it is not given."""
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
        w_packed: :func:`pack_weights` of ``w_q``, made here when the wgmma, halo or
            pointwise route needs it and it is not given
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

