"""The int8 conv's halo route, on the CPU: which shapes it takes, its column tiles, the
forced launches it accepts and refuses, and the packed weights it reads (the wgmma
route's): unpacked back to ``kernel_q`` and, through a plain im2col over the
halo's q space (the padded input's rows, computed columns included), equal to
``int8_conv_acc_plain``. The CUDA kernel itself is held against the plain version and
the wgmma route in ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from holocron_tpu_torch import quant
from holocron_tpu_torch.kernels import int8_conv as K

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "c,o,ksize,stride,padding,dilation,groups,route",
    [
        (48, 48, 3, 1, 1, 1, 1, "halo"),       # repvgg_a0's 48-channel stride-1 layers
        (64, 64, 3, 1, 1, 1, 1, "wgmma"),      # resnet50's first stage, unet3p's small maps, yolov4
        (64, 128, 3, 1, 1, 1, 1, "wgmma"),     # darknet53's first stage
        (40, 24, 3, 1, 1, 1, 1, "halo"),       # three planes (pitch 48)
        (3, 8, 3, 1, 1, 1, 1, "halo"),         # C = 3 at its 16-byte pitch
        (16, 8, 2, 1, 0, 1, 1, "halo"),        # 2x2 unpadded (an s2d fold of C = 4)
        (16, 48, (5, 3), 1, (2, 1), 1, 1, "halo"),
        (16, 8, (1, 3), 1, (0, 1), 1, 1, "halo"),  # two taps
        (96, 96, 3, 1, 1, 1, 1, "wgmma"),      # C > 48
        (192, 192, 3, 1, 1, 1, 1, "wgmma"),
        (1280, 1280, 3, 1, 1, 1, 1, "wgmma"),
        (48, 48, 3, 2, 1, 1, 1, "wgmma"),      # strided
        (32, 8, 3, 1, 2, 2, 1, "wgmma"),       # dilated
        (16, 70, 3, 1, 1, 1, 1, "wgmma"),      # O % 8 != 0: the masked epilogue
        (12, 20, 3, 1, 1, 1, 1, "wgmma"),
        (16, 8, 9, 1, 4, 1, 1, "wgmma"),       # 81 taps: more than the kernel's 64
        (16, 16, 1, 1, 0, 1, 1, "pointwise"),
        (16, 16, 1, 1, 1, 1, 1, "wgmma"),      # 1x1 padded: one tap
        (64, 64, 3, 1, 1, 1, 4, "general"),
    ],
)
def test_halo_route_by_shape(c, o, ksize, stride, padding, dilation, groups, route):
    """``conv_route`` gives the halo route to the ungrouped KxK (2 to 64 taps) convs of
    stride 1 and dilation 1 with O % 8 == 0 and C <= 48; ``halo_takes`` is the kernel's
    own limit, which drops only the channel rule."""
    assert K.conv_route(c, o, groups, kernel_size=ksize, stride=stride, padding=padding, dilation=dilation) == route
    kh, kw = (ksize, ksize) if isinstance(ksize, int) else ksize
    takes = groups == 1 and stride == 1 and dilation == 1 and 2 <= kh * kw <= 64 and o % 8 == 0
    assert K.halo_takes(c, o, groups, kernel_size=ksize, stride=stride, dilation=dilation) == takes
    assert (route == "halo") == (takes and c <= K.HALO_MAX_C)


def test_quantized_conv2d_route_reads_its_dilation():
    """A layer's route is its conv's, dilation included; a dilated 3x3 stays on wgmma."""
    w_q = torch.zeros(3, 3, 16, 16, dtype=torch.int8)
    for dilation, route in ((1, "halo"), (2, "wgmma")):
        conv = torch.nn.Conv2d(16, 16, 3, padding=dilation, dilation=dilation)
        assert quant.QuantizedConv2d(conv, w_q, torch.ones(16)).route == route


@pytest.mark.parametrize(
    "c,o,hw,batch,route",
    [
        (48, 48, 112, 1, "wgmma"),    # 12,544 output pixels
        (48, 48, 112, 8, "wgmma"),    # 100,352
        (48, 48, 112, 31, "wgmma"),   # 388,864
        (48, 48, 112, 32, "halo"),    # 401,408: HALO_MIN_ROWS
        (48, 48, 56, 8, "wgmma"),     # 25,088
        (48, 48, 56, 128, "halo"),    # 401,408
        (48, 48, 56, 256, "halo"),
        (96, 96, 28, 256, "wgmma"),   # C > 48 at any launch
        (16, 16, 56, 1, "pointwise"),  # 1x1: the launch size changes nothing
    ],
)
def test_halo_route_by_launch_size(c, o, hw, batch, route):
    """A halo-shaped conv takes the halo route on a launch of at least ``HALO_MIN_ROWS``
    output pixels, the wgmma route on a smaller one (``conv_route``'s ``rows``); None
    asks for the layer's route. ``QuantizedConv2d.route_for`` gives the same for an
    input, and ``route`` the layer's."""
    k = 1 if route == "pointwise" else 3
    rows = batch * hw * hw
    assert K.conv_route(c, o, kernel_size=k, padding=k // 2, rows=rows) == route
    assert (rows >= K.HALO_MIN_ROWS) == (route == "halo") or c > K.HALO_MAX_C or k == 1
    conv = torch.nn.Conv2d(c, o, k, padding=k // 2)
    layer = quant.QuantizedConv2d(conv, torch.zeros(k, k, c, o, dtype=torch.int8), torch.ones(o))
    assert layer.route_for(torch.empty(batch, c, hw, hw, device="meta")) == route
    assert layer.route == K.conv_route(c, o, kernel_size=k, padding=k // 2) == layer.route_for(None)


def test_route_for_reads_the_output_size():
    """``route_for`` counts the conv's output pixels: a valid 3x3 conv on 58 x 58 maps
    has 56 x 56 outputs, a stride-2 conv a quarter (and no halo route), and an
    ``s2d_strided`` layer's fold over 4C channels the route of a 2x2 conv."""
    w_q = torch.zeros(3, 3, 48, 48, dtype=torch.int8)
    valid = quant.QuantizedConv2d(torch.nn.Conv2d(48, 48, 3), w_q, torch.ones(48))
    assert valid.route_for(torch.empty(128, 48, 58, 58, device="meta")) == "halo"  # 128 * 56 * 56 = HALO_MIN_ROWS
    assert valid.route_for(torch.empty(128, 48, 57, 58, device="meta")) == "wgmma"
    strided = quant.QuantizedConv2d(torch.nn.Conv2d(48, 48, 3, stride=2, padding=1), w_q, torch.ones(48))
    assert strided.route_for(torch.empty(256, 48, 112, 112, device="meta")) == "wgmma"
    s2d = quant.QuantizedConv2d(torch.nn.Conv2d(48, 48, 3, stride=2, padding=1), w_q, torch.ones(48),
                                s2d_strided=True)
    assert s2d.s2d and s2d.route == K.conv_route(192, 48, kernel_size=2) == "wgmma"
    assert s2d.route_for(torch.empty(256, 48, 112, 112, device="meta")) == "wgmma"


@pytest.mark.parametrize("o,bn", [(8, 48), (24, 48), (48, 48), (56, 64), (64, 64), (72, 96), (96, 96), (128, 128),
                                  (192, 96), (256, 128), (320, 64), (1280, 128)])
def test_halo_column_tile(o, bn):
    """The width of 48, 64, 96 and 128 that pads O least, the widest of those that tie
    (72: 96 and 48 both pad to 96)."""
    assert K.halo_tile_n(o) == bn
    padded = {n: -(-o // n) * n for n in K.HALO_TILE_N}
    assert padded[bn] == min(padded.values()) and bn == max(n for n in K.HALO_TILE_N if padded[n] == padded[bn])


def test_forced_routes_the_launch_refuses():
    """A forced ``route`` is checked against the shape before any operand: the halo route
    refuses a strided, dilated, grouped or O % 8 != 0 conv, and the pointwise route any
    other conv than its own."""
    x = torch.zeros(1, 8, 8, 16, dtype=torch.int8)
    cases = [((3, 3, 16, 16), 2, 1, 1, "halo"), ((3, 3, 16, 16), 1, 1, 2, "halo"), ((3, 3, 16, 12), 1, 1, 1, "halo"),
             ((3, 3, 16, 16), 1, 1, 1, "pointwise"), ((1, 1, 16, 16), 1, 0, 1, "halo")]
    for shape, stride, padding, dilation, route in cases:
        with pytest.raises(ValueError, match=f"the {route} route does not take"):
            K._launch(x, torch.zeros(shape, dtype=torch.int8), None, None, None, None, stride, padding, dilation,
                      torch.int32, 1, route=route)
    with pytest.raises(ValueError, match="CUDA device"):  # the shapes it takes pass on to the operand checks
        K._launch(x, torch.zeros(3, 3, 16, 16, dtype=torch.int8), None, None, None, None, 1, 1, 1, torch.int32, 1,
                  route="halo")


def _halo_im2col_acc(x_q: torch.Tensor, packed: torch.Tensor, kh: int, kw: int, ph: int, pw: int, o: int):
    """The halo route's arithmetic as a plain GEMM: the NHWC buffer under x_q padded into
    the q space (row q = y * (W + 2 PW) + x of an image's padded input, columns past OW
    computed too), each row's K = KH * KW * pitch bytes read in the packed order (tap,
    then the pitch's channels) at q + r * (W + 2 PW) + s, times the packed weights'
    first K columns, in float64 (exact); the computed-only columns dropped."""
    n, h, w, c = x_q.shape
    pitch = x_q.stride(2)
    buf = x_q.as_strided((n, h, w, pitch), x_q.stride()).double()
    wq = w + 2 * pw
    padded = F.pad(buf, (0, 0, pw, pw, ph, ph + 1))  # one more row: the last row's computed columns read past it
    flat = padded.reshape(n, -1, pitch)
    oh, ow = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    q = torch.arange(oh * wq)
    cols = [flat[:, q + r * wq + s] for r in range(kh) for s in range(kw)]  # (n, q, pitch) each
    a = torch.cat(cols, dim=-1)  # (n, q, K) in (tap, channel) order
    k = kh * kw * pitch
    acc = a @ packed[:o, :k].double().t()
    return acc.reshape(n, oh, wq, o)[:, :, :ow].to(torch.int32)


@pytest.mark.parametrize(
    "n,h,w,c,o,kh,kw,ph,pw",
    [(2, 7, 7, 48, 48, 3, 3, 1, 1), (1, 1, 1, 16, 8, 3, 3, 1, 1), (3, 2, 2, 32, 8, 3, 3, 1, 1),
     (2, 9, 11, 40, 24, 2, 2, 0, 0), (1, 12, 10, 16, 64, 5, 3, 2, 1), (1, 6, 13, 3, 16, 3, 3, 1, 1),
     (2, 5, 6, 24, 16, 3, 3, 0, 0)],
)
def test_halo_q_space_over_the_packed_weights_is_the_conv(n, h, w, c, o, kh, kw, ph, pw):
    """The packed weights unpack to w_q, and the q-space GEMM the halo kernel computes
    over them (its padded rows' pixels at every tap, plane 0 again where it holds it:
    the same bytes) equals the float64 plain conv exactly, on x_q at its pitch."""
    rng = np.random.default_rng(h * w + c)
    x_q = K.quantize_activation_plain(torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)),
                                      torch.tensor(0.02))
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(kh, kw, c, o), dtype=np.int8))
    packed = K.pack_weights(w_q)
    pitch = K.channel_pitch(c)
    taps = packed[:o, : kh * kw * pitch].reshape(o, kh, kw, pitch)
    assert torch.equal(taps[..., :c].permute(1, 2, 3, 0), w_q) and not taps[..., c:].any()
    ref = K.int8_conv_acc_plain(x_q, w_q, 1, (ph, pw))
    assert torch.equal(_halo_im2col_acc(x_q, packed, kh, kw, ph, pw, o), ref)
