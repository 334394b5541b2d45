"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each is marked
``cuda`` and skips where ``torch.cuda.is_available()`` is false. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from holocron_tpu_torch.kernels import add2d as A
from holocron_tpu_torch.kernels import involution as V
from holocron_tpu_torch.kernels import int8_conv as Q
from holocron_tpu_torch.kernels.int8_conv import KERNEL as INT8_KERNEL
from holocron_tpu_torch.kernels.int8_conv import int8_conv, int8_conv_acc, int8_conv_acc_plain, int8_conv_plain
from holocron_tpu_torch.kernels.involution import involution_stencil, involution_stencil_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the backward's shapes: 19 x 37 and 13 x 9 cross tile edges that are not multiples of
# the tile, C 256 in 2 groups holds 16 or 32 vectors a group, k 3, 5, 7 and k 1 (outside
# the unrolled set), and the path's 32 x 56 x 56 x 128, G8, k7
_INVOLUTION_SHAPES = [(2, 5, 7, 24, 3, 3), (1, 9, 9, 16, 4, 5), (2, 6, 6, 64, 4, 3), (3, 4, 4, 32, 32, 1),
                      (32, 56, 56, 128, 8, 7), (2, 19, 37, 64, 4, 7), (1, 13, 9, 32, 4, 3), (2, 3, 2, 256, 2, 5)]


def _involution_fwd_routes():
    """Each forward route's wrapper and launch counter."""
    return {"tiled": (V.involution_stencil_tiled, V.KERNEL), "general": (V.involution_stencil_general,
                                                                          V.KERNEL_GENERAL)}


def _involution_fwd_matches_plain(cuda, n, h, w, c, g, k, dtype, fn, route):
    """Both accumulate in float32 in tap order with separate roundings: equal. Only the
    route's counter moves, by one."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=cuda).to(dtype)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=cuda).to(dtype)
    counters = [kernel for _, kernel in _involution_fwd_routes().values()]
    before = [kernel.launches for kernel in counters]
    out = fn(xp, kern, k, g)
    torch.cuda.synchronize()
    moved = _involution_fwd_routes()[route][1]
    assert [kernel.launches - b for kernel, b in zip(counters, before)] == [int(kernel is moved) for kernel in counters]
    torch.testing.assert_close(out, involution_stencil_plain(xp, kern, k, g), rtol=0, atol=0)


@pytest.mark.parametrize("n,h,w,c,g,k", [(3, 4, 4, 8, 8, 1), *_INVOLUTION_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_involution_kernel_matches_plain(cuda, n, h, w, c, g, k, dtype):
    """involution_stencil through the route bwd_route picks: tiled where a group is whole
    16-byte vectors, general for cg = 4 in bf16 and cg = 1."""
    _involution_fwd_matches_plain(cuda, n, h, w, c, g, k, dtype, involution_stencil, V.bwd_route(c, g, dtype))


@pytest.mark.parametrize("n,h,w,c,g,k", [(2, 19, 37, 64, 4, 7), (2, 6, 6, 64, 4, 3), (32, 56, 56, 128, 8, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_involution_general_forward_matches_plain_at_tiled_shapes(cuda, n, h, w, c, g, k, dtype):
    """The general route's forward takes any shape, bit for bit the plain version where
    the tiled route would be picked."""
    _involution_fwd_matches_plain(cuda, n, h, w, c, g, k, dtype, V.involution_stencil_general, "general")


def test_involution_forward_wrappers_refuse_what_they_do_not_take(cuda):
    """Every forward wrapper refuses float16 and operands off one CUDA device; the tiled
    one also refuses groups that are not whole 16-byte vectors and 2^31 elements or
    more (from the shapes, before any copy). Nothing launches."""
    counters = [kernel for _, kernel in _involution_fwd_routes().values()]
    before = [kernel.launches for kernel in counters]
    n, h, w, c, g, k = 1, 4, 4, 32, 4, 3
    xp, kern = torch.zeros(n, h + k - 1, w + k - 1, c, device=cuda), torch.zeros(n, h, w, k * k * g, device=cuda)
    for fn in (involution_stencil, V.involution_stencil_tiled, V.involution_stencil_general):
        with pytest.raises(TypeError):
            fn(xp.half(), kern.half(), k, g)
        with pytest.raises(ValueError):
            fn(xp, kern.cpu(), k, g)
    bf_kern = torch.zeros(n, h, w, k * k * 8, device=cuda, dtype=torch.bfloat16)  # G = 8: cg = 4, 8 bytes
    with pytest.raises(ValueError, match="16-byte"):
        V.involution_stencil_tiled(xp.to(torch.bfloat16), bf_kern, k, 8)
    huge_n = 2**31 // ((h + k - 1) * (w + k - 1) * c) + 1
    with pytest.raises(ValueError, match="32 bits"):
        V.involution_stencil_tiled(xp.expand(huge_n, -1, -1, -1), kern.expand(huge_n, -1, -1, -1), k, g)
    torch.cuda.synchronize()
    assert [kernel.launches for kernel in counters] == before


@pytest.mark.parametrize(
    "n,h,w,c,o,ksize,stride,padding,dilation",
    [
        (2, 9, 10, 16, 24, 3, 1, 1, 1),    # ragged M and O tiles
        (2, 9, 10, 48, 72, 3, 2, 1, 1),    # stride 2, C not a multiple of the 128-byte step
        (1, 11, 11, 32, 8, 3, 1, 2, 2),    # dilation 2
        (2, 8, 8, 16, 16, 1, 2, 0, 1),     # 1x1 stride 2, K below one step
        (1, 11, 11, 12, 8, 3, 1, 2, 2),    # C % 16 != 0 (a contiguous x_q padded to its pitch), dilation 2
        (2, 7, 7, 3, 5, 3, 1, 1, 1),       # C = 3, odd O: the masked epilogue
        (2, 9, 10, 16, 70, 3, 2, 1, 1),    # O % 8 != 0 in a 96-wide tile
        (1, 14, 14, 192, 192, 3, 1, 1, 1),  # repvgg_a0 stage-3 conv
    ],
)
def test_int8_conv_kernel_matches_plain(cuda, n, h, w, c, o, ksize, stride, padding, dilation):
    """int32 accumulator exact; float32 output within one float32 ulp and bf16 output
    within one bf16 ulp of the plain epilogue, from a contiguous int8 x_q."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x_q = torch.randint(-127, 128, (n, h, w, c), generator=gen, device=cuda, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    counter = INT8_KERNEL if Q.conv_route(c, o) == "wgmma" else Q.KERNEL_GENERAL
    before = counter.launches
    acc = int8_conv_acc(x_q, w_q, stride, padding, dilation)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(acc, int8_conv_acc_plain(x_q, w_q, stride, padding, dilation).contiguous())
    s_x = torch.tensor(0.013, device=cuda)
    w_scale = torch.rand(o, generator=gen, device=cuda) / 127
    for bias in (None, torch.randn(o, generator=gen, device=cuda)):
        for dtype, ulp in ((torch.float32, 2.0**-23), (torch.bfloat16, 2.0**-7)):
            b = None if bias is None else bias.to(dtype)
            got = int8_conv(x_q, w_q, s_x, w_scale, b, stride, padding, dilation, out_dtype=dtype).float()
            ref = int8_conv_plain(x_q, w_q, s_x, w_scale, b, stride, padding, dilation, out_dtype=dtype).float()
            assert bool(((got - ref).abs() <= ref.abs() * ulp).all())


def _pad_of(x_q):
    """Channels C .. pitch - 1 of a quantized activation, which lies at its pitch."""
    pitch = Q.channel_pitch(x_q.shape[-1])
    assert x_q.stride()[-2:] == (pitch, 1)
    return x_q.as_strided((*x_q.shape[:-1], pitch), x_q.stride())[..., x_q.shape[-1]:]


def _int8_route_matches_plain(cuda, x, w_q, stride, padding, dilation, seed, groups=1, expected_route="wgmma"):
    """quantize + conv on the card against quantize_activation_plain + the plain conv:
    quantized activations equal (their pitch's pad zero), int32 accumulator equal, float32 within one float32
    ulp and bf16 within one bf16 ulp, with and without bias; conv_route picks
    ``expected_route``, and the quantization counter and that route's counter advance
    once each, the other route's not at all."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c, o = w_q.shape[2], w_q.shape[3]
    route = Q.conv_route(c, o, groups)
    assert route == expected_route
    s_x = x.float().abs().amax() / 127
    w_scale = torch.rand(o, generator=gen, device=cuda) / 127
    packed = Q.pack_weights(w_q) if route == "wgmma" else None
    x_q = Q.quantize_activation(x, s_x)
    assert torch.equal(x_q, Q.quantize_activation_plain(x, s_x))
    assert not bool(_pad_of(x_q).any())
    acc = int8_conv_acc(x_q, w_q, stride, padding, dilation, w_packed=packed, groups=groups)
    assert torch.equal(acc, int8_conv_acc_plain(x_q, w_q, stride, padding, dilation, groups).contiguous())
    for bias in (None, torch.randn(o, generator=gen, device=cuda)):
        for dtype, ulp in ((torch.float32, 2.0**-23), (torch.bfloat16, 2.0**-7)):
            b = None if bias is None else bias.to(dtype)
            before = (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches, Q.KERNEL_GENERAL.launches)
            got = Q.quantized_conv(x, s_x, w_q, w_scale, b, stride, padding, dilation, out_dtype=dtype,
                                   w_packed=packed, groups=groups)
            torch.cuda.synchronize()
            wgmma = int(route == "wgmma")
            assert (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches, Q.KERNEL_GENERAL.launches) == (
                before[0] + wgmma, before[1] + 1, before[2] + 1 - wgmma)
            ref = int8_conv_plain(x_q, w_q, s_x, w_scale, b, stride, padding, dilation, out_dtype=dtype,
                                  groups=groups).float()
            assert got.dtype == dtype
            assert bool(((got.float() - ref).abs() <= ref.abs() * ulp).all())


@pytest.mark.parametrize(
    "hw,c,o,stride",
    [(112, 48, 48, 1), (112, 48, 48, 2), (56, 48, 48, 1), (56, 48, 96, 2), (28, 96, 96, 1), (28, 96, 192, 2),
     (14, 192, 192, 1), (14, 192, 1280, 2), (7, 1280, 1280, 1)],
)
def test_int8_route_at_repvgg_a0_geometries(cuda, hw, c, o, stride):
    """The nine int8 layer geometries of repvgg_a0 (3x3, padding 1), batch 2."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(2, hw, hw, c, generator=gen, device=cuda).relu().to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (3, 3, c, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, stride, 1, 1, 7)


@pytest.mark.parametrize(
    "n,hw,c,o,ksize,stride,padding",
    [
        (2, 14, 64, 64, 1, 1, 0),       # 1x1, C = 64: K is half of one 128-byte step
        (2, 14, 64, 256, 1, 1, 0),      # 1x1 C64 -> O256 (and the stage-1 shortcut)
        (2, 14, 256, 512, 1, 2, 0),     # 1x1 stride-2 projection, no padding, even map
        (2, 7, 1024, 2048, 1, 2, 0),    # 1x1 stride 2 on an odd map, O = 2048: eight 256-wide column tiles
        (8, 7, 512, 2048, 1, 1, 0),     # O = 2048 at batch 8, 7 x 7: M = 392, most blocks idle
        (8, 7, 2048, 512, 1, 1, 0),     # C = 2048 (K = 16 steps), M = 392
        (2, 14, 128, 128, 3, 2, 1),     # 3x3 stride 2
        (8, 7, 512, 512, 3, 1, 1),      # 3x3 at 7 x 7, batch 8
    ],
)
def test_int8_route_at_resnet50_geometries(cuda, n, hw, c, o, ksize, stride, padding):
    """Small-batch copies of resnet50's int8 layer geometries that repvgg_a0 never
    reaches."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(n, hw, hw, c, generator=gen, device=cuda).relu().to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, stride, padding, 1, 11)


@pytest.mark.parametrize(
    "n,hw,c,o,ksize,stride,padding",
    [
        (2, 112, 96, 27, 1, 1, 0),    # rexnet1_0x's first int8 conv: odd O in one 48-wide tile, one flat run
        (2, 56, 162, 38, 1, 1, 0),    # C % 16 != 0 (pitch 176), O % 8 != 0
        (8, 1, 228, 19, 1, 1, 0),     # an SE squeeze on its 1 x 1 input: M = 8, odd O
        (8, 1, 75, 906, 1, 1, 0),     # an SE excite: odd C, O across four 256-wide column tiles
        (2, 28, 72, 432, 1, 1, 0),    # an expand: C % 16 != 0, O % 8 == 0 (whole 16-byte rows)
        (2, 14, 106, 636, 1, 1, 0),   # an expand with O % 8 == 4: rows 8-byte aligned in bf16
        (2, 7, 1044, 185, 1, 1, 0),   # the last projection: odd O over six 32-column chunks, C % 16 == 4
        (2, 7, 185, 1280, 1, 1, 0),   # the penultimate conv: odd C
        (3, 5, 768, 140, 1, 1, 0),    # C % 16 == 0, O % 8 == 4, ragged M
    ],
)
def test_int8_route_at_rexnet1_0x_geometries(cuda, n, hw, c, o, ksize, stride, padding):
    """rexnet1_0x's int8 geometries, all on the wgmma route, at small batches: odd
    output widths (the masked epilogue), channel counts that are not whole 16-byte runs
    (the padded pitch) and 1 x 1 spatial inputs (the M tail)."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(n, hw, hw, c, generator=gen, device=cuda).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, stride, padding, 1, 14)


def _wgmma_case_is_exact(cuda, n, h, w, c, o, ksize, stride, padding, seed):
    """quantize + wgmma conv against the plain versions, bit for bit: the quantized
    activation and its zero pad, the int32 accumulator, and float32 and bf16 outputs
    with no bias and with a float32 and a bf16 one (the epilogue's roundings are the
    plain version's, in its order)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=gen, device=cuda).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    assert Q.conv_route(c, o) == "wgmma"
    s_x = x.float().abs().amax() / 127
    w_scale = torch.rand(o, generator=gen, device=cuda) / 127
    packed = Q.pack_weights(w_q)
    x_q = Q.quantize_activation(x, s_x)
    assert torch.equal(x_q, Q.quantize_activation_plain(x, s_x)) and not bool(_pad_of(x_q).any())
    before = INT8_KERNEL.launches
    acc = int8_conv_acc(x_q, w_q, stride, padding, w_packed=packed)
    torch.cuda.synchronize()
    assert INT8_KERNEL.launches == before + 1
    assert acc.dtype == torch.int32 and torch.equal(acc, int8_conv_acc_plain(x_q, w_q, stride, padding))
    bias = torch.randn(o, generator=gen, device=cuda)
    for b in (None, bias, bias.to(torch.bfloat16)):
        for dtype in (torch.float32, torch.bfloat16):
            got = int8_conv(x_q, w_q, s_x, w_scale, b, stride, padding, out_dtype=dtype, w_packed=packed)
            ref = int8_conv_plain(x_q, w_q, s_x, w_scale, b, stride, padding, out_dtype=dtype)
            assert got.dtype == dtype and torch.equal(got, ref), (dtype, None if b is None else b.dtype)


@pytest.mark.parametrize("o", [*range(249, 257), *range(257, 265)])
@pytest.mark.parametrize("n,h,w", [(1, 11, 25), (2, 66, 67)])
def test_int8_wgmma_masked_epilogue_at_every_o_residue(cuda, o, n, h, w):
    """Every O % 8 residue on both sides of a 256-wide column tile (one tile up to 256,
    a second one past it). M = 275 (two row tiles and a tail of 19 rows): past 256
    columns, fewer 256-wide tiles than SMs, so 64-wide ones; M = 8,844: 256-wide ones."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    expected = 64 if o > 256 and -(-n * h * w // 128) * 2 < sms else Q.tile_n(o)
    assert Q.launch_tile_n(o, n * h * w, sms) == expected
    _wgmma_case_is_exact(cuda, n, h, w, 32, o, 1, 1, 0, 20 + o)


@pytest.mark.parametrize("c", [16 * (r % 3) + r for r in range(1, 16)])
def test_int8_wgmma_padded_pitch_at_every_c_residue(cuda, c):
    """Every C % 16 residue: x_q at its padded pitch, the weights packed over it; O = 40 + C
    takes every O % 8 residue alongside."""
    _wgmma_case_is_exact(cuda, 2, 9, 7, c, 40 + c, 1, 1, 0, 40 + c)


@pytest.mark.parametrize(
    "n,h,w,c,o,ksize,stride,padding",
    [
        (2, 9, 10, 21, 27, 3, 1, 1),   # 3x3, odd C: the pitch's pad at every tap
        (2, 9, 10, 45, 70, 3, 2, 1),   # 3x3 stride 2, odd C
        (8, 1, 1, 228, 19, 1, 1, 0),   # M = 8 (an SE squeeze at batch 8)
        (256, 1, 1, 840, 70, 1, 1, 0),  # M = 256 (the SE squeeze at batch 256)
        (256, 1, 1, 70, 840, 1, 1, 0),  # M = 256, O = 840 (the SE excite)
        (3, 7, 7, 96, 27, 1, 1, 0),    # M = 147: one full tile and a tail of 19 rows, flat runs
        (1, 13, 13, 162, 185, 1, 1, 0),  # M = 169, O = 185: runs a row, odd O in a 192-wide tile
    ],
)
def test_int8_wgmma_taps_strides_and_m_tails(cuda, n, h, w, c, o, ksize, stride, padding):
    _wgmma_case_is_exact(cuda, n, h, w, c, o, ksize, stride, padding, 60 + c)


@pytest.mark.parametrize("c", [1, 3, 8, 12, 16, 20, 24, 27, 33, 48, 185])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_writes_the_pitch(cuda, c, dtype):
    """The quantization kernel at C of each load width (2-, 4-, 8- and 16-byte aligned
    rows in bf16, 4 to 16 in float32): equal to the plain version, the view lying at
    ``channel_pitch(C)`` and its pad zero; at C % 16 == 0 the contiguous buffer."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = (4 * torch.randn(3, 5, 7, c, generator=gen, device=cuda)).to(dtype)
    s_x = torch.tensor(0.05, device=cuda)
    before = Q.KERNEL_QUANTIZE.launches
    x_q = Q.quantize_activation(x, s_x)
    torch.cuda.synchronize()
    assert Q.KERNEL_QUANTIZE.launches == before + 1
    assert torch.equal(x_q, Q.quantize_activation_plain(x, s_x))
    assert not bool(_pad_of(x_q).any())
    assert x_q.is_contiguous() == (c % 16 == 0)


@pytest.mark.parametrize(
    "n,hw,c,o,groups,stride",
    [
        (2, 7, 2048, 2048, 32, 1),    # resnext101_32x8d's stage-4 3x3: 32 groups of 64 (fast staging)
        (2, 14, 2048, 2048, 32, 2),   # the stride-2 first block of that stage
        (2, 9, 24, 12, 3, 1),         # 3 groups of 8 channels in, 4 out: byte-wise
        (1, 6, 15, 35, 5, 2),         # 5 groups of 3 in, 7 out: odd per-group widths
        (2, 8, 64, 64, 2, 1),         # 2 groups of 32 (the CPU tests' small ResNeXt)
    ],
)
def test_int8_grouped_general_route(cuda, n, hw, c, o, groups, stride):
    """Grouped convs take the general route, one GEMM a group (the grid's third
    dimension), against the grouped float64 plain conv: exact accumulator, outputs
    within one ulp."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn(n, hw, hw, c, generator=gen, device=cuda).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (3, 3, c // groups, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, stride, 1, 1, 16, groups, expected_route="general")


def test_int8_rexnet_takes_only_the_wgmma_route(cuda):
    """A small int8 ReXNet (``min_in_channels=16``, odd widths) on the card: each int8
    layer launches the quantization kernel and the wgmma conv once a forward, the
    general route never; its logits agree with the CPU's plain int8 form within 1e-3 of
    their largest magnitude (as the ResNet's below)."""
    import copy

    from holocron_tpu_torch import quant
    from holocron_tpu_torch.models import ReXNet

    gen = torch.Generator().manual_seed(17)
    model = ReXNet(0.5, 0.5, num_classes=10, generator=gen, device="cpu").eval()
    x = torch.randn(4, 3, 32, 32, generator=gen)
    qm = quant.quantize_model(model, calibration_batches=[x], min_in_channels=16)
    layers = [m for m in qm.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert layers and all(m.groups == 1 and m.kernel_packed is not None for m in layers)
    assert any(m.kernel_q.shape[2] % 16 or m.kernel_q.shape[3] % 8 for m in layers)
    with torch.no_grad():
        ref = qm(x)
        qm_card = copy.deepcopy(qm).to(cuda)
        before = (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches, Q.KERNEL_GENERAL.launches)
        out = qm_card(x.to(cuda).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
    assert (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches, Q.KERNEL_GENERAL.launches) == (
        before[0] + len(layers), before[1] + len(layers), before[2])
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-3 * float(ref.abs().max()))


def test_int8_resnet_takes_only_the_wgmma_route(cuda):
    """A small int8 ResNet on the card: every int8 layer (every conv but the 3-channel
    stem) launches the quantization kernel and the wgmma conv once a forward, the
    general route never; its logits agree with the CPU's plain int8 form within 1e-3 of
    their largest magnitude (the convs agree to an ulp of float32, but BN and ReLU
    between them round differently on the card and may move an activation across a
    quantization tie)."""
    import copy

    from holocron_tpu_torch import quant
    from holocron_tpu_torch.models import Bottleneck, ResNet

    gen = torch.Generator().manual_seed(12)
    model = ResNet(Bottleneck, [1, 1], [16, 32], generator=gen, device="cpu").eval()
    x = torch.randn(4, 3, 32, 32, generator=gen)
    qm = quant.quantize_model(model, calibration_batches=[x], min_in_channels=16)
    layers = sum(isinstance(m, quant.QuantizedConv2d) for m in qm.modules())
    assert layers == 7  # the first stage has no shortcut conv: 64 channels in and out
    with torch.no_grad():
        ref = qm(x)
        qm_card = copy.deepcopy(qm).to(cuda)
        before = (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches, Q.KERNEL_GENERAL.launches)
        out = qm_card(x.to(cuda).contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
    assert (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches, Q.KERNEL_GENERAL.launches) == (
        before[0] + layers, before[1] + layers, before[2])
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-3 * float(ref.abs().max()))


@pytest.mark.parametrize(
    "n,h,w,c,o,ksize,stride,padding,dilation,dtype",
    [
        (3, 5, 7, 48, 48, 3, 1, 1, 1, torch.bfloat16),      # ragged M (105 rows), C = 48 (K = 432)
        (1, 9, 11, 48, 1280, 3, 2, 1, 1, torch.float32),    # O = 1280 over five 256-wide tiles, float32 x
        (2, 6, 5, 64, 320, 3, 1, 2, 2, torch.bfloat16),     # O = 320: a 256-wide tile and a padded one; dilation
        (1, 4, 4, 16, 8, 1, 1, 0, 1, torch.float32),        # the narrowest shapes the route takes
        (2, 13, 3, 32, 24, 3, 2, 1, 1, torch.bfloat16),     # non-square, tile 48 > O
    ],
)
def test_int8_route_edge_cases(cuda, n, h, w, c, o, ksize, stride, padding, dilation, dtype):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(n, h, w, c, generator=gen, device=cuda).to(dtype)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, stride, padding, dilation, 9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_ties_and_clip(cuda, dtype):
    """Exactly on the ties (k + 0.5) * s_x (s_x a power of two, so the division is
    exact), one ulp either side, at and beyond +-127 * s_x, zeros; and near the ties of
    a scale that is not a power of two: equal to the plain version, with a ragged tail
    (the length is not a multiple of 16: one row whose pitch ends in zeros)."""
    s = torch.tensor(2.0**-5, device=cuda)
    k = torch.arange(-140, 141, device=cuda, dtype=torch.float32)
    ties = (k + 0.5) * s
    x = torch.cat([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1), k * s,
                   torch.tensor([127.0, -127.0, 127.49, -127.51, 1e6, -1e6, 0.0, -0.0], device=cuda) * s])
    assert x.numel() % 16 != 0
    before = Q.KERNEL_QUANTIZE.launches
    for xs, sx in ((x, s), (x / s * 0.0123, torch.tensor(0.0123, device=cuda))):
        xs = xs.to(dtype)
        assert torch.equal(Q.quantize_activation(xs, sx), Q.quantize_activation_plain(xs, sx))
    torch.cuda.synchronize()
    assert Q.KERNEL_QUANTIZE.launches == before + 2


def test_int8_conv_refuses_what_it_does_not_take(cuda):
    x_q = torch.zeros(1, 4, 4, 8, dtype=torch.int8, device=cuda)
    w_q = torch.zeros(3, 3, 8, 8, dtype=torch.int8, device=cuda)
    s_x, w_scale = torch.tensor(1.0, device=cuda), torch.ones(8, device=cuda)
    before = INT8_KERNEL.launches
    with pytest.raises(ValueError):  # groups=2 needs w_q of 4 input channels a group
        int8_conv(x_q, w_q, s_x, w_scale, groups=2)
    with pytest.raises(ValueError):
        int8_conv(x_q, w_q.cpu(), s_x, w_scale)
    with pytest.raises(ValueError):
        int8_conv(x_q.permute(0, 2, 1, 3), w_q, s_x, w_scale)
    assert INT8_KERNEL.launches == before


def _within(got, ref, bound, what):
    err = (got.float() - ref.float()).abs()
    assert bool((err <= bound).all()), f"{what}: max error {float(err.max())}, worst excess {float((err - bound).max())}"


def _add2d_bounds(p, w, g, dtype):
    """Error bounds of the add2d kernels against their plain versions. Forward: a sum of
    D non-negative terms, added in another order: rtol 1e-4. Gradients: signed sums of
    +-g over O (dp) or L (dw), so the rounding grows with sum |g| over that axis
    (about sqrt(n) * 2^-24 * sum |g| in float32): 2e-5 * sum |g|. A bf16 result adds one
    rounding of each side: 2^-7 of the value."""
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    gf = g.float().abs()
    fwd = lambda ref: ref.float().abs() * (1e-4 + ulp)  # noqa: E731
    dp = lambda ref: 2e-5 * gf.sum(1, keepdim=True) + ulp * ref.float().abs()  # noqa: E731
    dw = lambda ref: 2e-5 * gf.sum(0, keepdim=True) + ulp * ref.float().abs()  # noqa: E731
    return fwd, dp, dw


@pytest.mark.parametrize("l,d,o", [(50, 36, 10), (130, 70, 67), (1, 9, 3), (300, 100, 72), (5000, 36, 10),
                                   (257, 576, 128), (33, 1001, 24), (12544, 576, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add2d_kernels_match_plain(cuda, l, d, o, dtype):
    """Forward, dp and dw at ragged shapes (L = 1; L not a multiple of a tile or of dw's
    32-row chunk; D and O not multiples of the 64-wide tile or of a chunk of the reduced
    dimension, with rows of whole 16-byte vectors or not; O = 24 below one chunk of dp;
    79 slices of L) and at the path's layer (L 12544, D 576, O 128). Each kernel gives
    the same bits on a second run (no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    p, w, g = (torch.randn(*s, generator=gen, device=cuda).to(dtype) for s in ((l, d), (d, o), (l, o)))
    fwd, dp, dw = _add2d_bounds(p, w, g, dtype)
    before = [k.launches for k in (A.KERNEL_FWD, A.KERNEL_BWD_DP, A.KERNEL_BWD_DW)]
    out, gp, gw = A.add2d_matmul(p, w), A.add2d_bwd_dp(p, w, g), A.add2d_bwd_dw(p, w, g)
    torch.cuda.synchronize()
    assert [k.launches for k in (A.KERNEL_FWD, A.KERNEL_BWD_DP, A.KERNEL_BWD_DW)] == [b + 1 for b in before]
    assert out.dtype == gp.dtype == gw.dtype == dtype
    ref = A.add2d_matmul_plain(p, w)
    _within(out, ref, fwd(ref), "forward")
    ref = A.add2d_bwd_dp_plain(p, w, g)
    _within(gp, ref, dp(ref), "dp")
    ref = A.add2d_bwd_dw_plain(p, w, g)
    _within(gw, ref, dw(ref), "dw")
    assert torch.equal(A.add2d_matmul(p, w), out) and torch.equal(A.add2d_bwd_dp(p, w, g), gp)
    assert torch.equal(A.add2d_bwd_dw(p, w, g), gw)


def _add2d_special_inputs(cuda, dtype):
    """Inputs at a ragged shape (L 700, D 70, O 72) with every special case of the sign:
    p == w wherever d < 8 (p constant down those columns, w's rows there equal to it), a
    NaN in p at (123, 40), a NaN in w at (50, 7), values beyond the scaled sign step's
    range (|x| >= 2^100): w at (60, 3) and p at (200, 10), and an infinite g at (300, 20)
    (an amp overflow), whose terms are Inf * +-1 and, where d < 8, Inf * 0 = NaN; w at
    (9, 20) lies below every p, so that sign is +1."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    l, d, o = 700, 70, 72
    p, w, g = (torch.randn(*s, generator=gen, device=cuda).to(dtype) for s in ((l, d), (d, o), (l, o)))
    p[:, :8] = p[:1, :8]
    w[:8, :] = p[0, :8, None]
    p[123, 40] = float("nan")
    w[50, 7] = float("nan")
    w[60, 3] = 2.0**101
    p[200, 10] = -(2.0**101)
    g[300, 20] = float("inf")
    w[9, 20] = -8.0
    return p, w, g


@pytest.mark.parametrize("fn", ["forward", "dp", "dw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add2d_kernels_keep_the_plain_zeros_and_nans(cuda, dtype, fn):
    """sign(0) = 0 and sign(NaN) = NaN, as jnp.sign. dp is 0 where p == w along all of O
    and dw where p == w along all of L; a NaN in p makes its element of dp and its row of
    dw NaN, a NaN in w its column of dp and its element of dw; the forward carries both
    NaNs into its rows or columns. An infinite g makes its row of dp and its column of dw
    +-Inf (NaN where p == w). Values beyond the scaled step's range take the exact step.
    The kernels have the plain versions' zeros, NaNs and infinities, and are within the
    stated tolerance elsewhere."""
    p, w, g = _add2d_special_inputs(cuda, dtype)
    fwd, dp, dw = _add2d_bounds(p, w, g, dtype)
    kernel, plain, bound = {"forward": (A.add2d_matmul, A.add2d_matmul_plain, fwd),
                            "dp": (A.add2d_bwd_dp, A.add2d_bwd_dp_plain, dp),
                            "dw": (A.add2d_bwd_dw, A.add2d_bwd_dw_plain, dw)}[fn]
    args = (p, w) if fn == "forward" else (p, w, g)
    ref, got = plain(*args), kernel(*args)
    if fn == "dp":
        rest = torch.arange(ref.shape[0], device=cuda) != 300
        assert bool((ref[rest, :8] == 0).all()) and bool(ref[123, 40].isnan()) and bool(ref[:, 50].isnan().all())
        assert int(ref[rest].isnan().sum()) == ref.shape[0] and bool(ref[rest, 60].isfinite().all())
        assert bool(ref[300, :8].isnan().all()) and bool(ref[300, 9] == -math.inf) and not bool(ref[300].isfinite().any())
    elif fn == "dw":
        rest = torch.arange(ref.shape[1], device=cuda) != 20
        assert bool((ref[:8, rest] == 0).all()) and bool(ref[:8, 20].isnan().all()) and bool(ref[40].isnan().all())
        assert bool(ref[50, 7].isnan()) and bool(ref[60, 3].isfinite()) and bool(ref[10, rest].isfinite().all())
        assert bool(ref[9, 20] == math.inf) and not bool(ref[:, 20].isfinite().any())
    else:
        assert bool(ref[123].isnan().all()) and bool(ref[:, 7].isnan().all())
    assert torch.equal(got.isnan(), ref.isnan()) and torch.equal(got == 0, ref == 0)
    assert torch.equal(got.isinf(), ref.isinf()) and torch.equal(got[ref.isinf()], ref[ref.isinf()])
    finite = ref.isfinite()
    _within(got[finite], ref[finite], bound(ref).expand_as(ref)[finite], fn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add2d_kernels_take_views_off_16_byte_boundaries(cuda, dtype):
    """Contiguous p, w and g that start one element into their storage, at a shape whose
    rows are whole 16-byte vectors (the pointers alone force element-wise staging), and
    at a ragged one: all three kernels within the stated tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    for l, d, o in ((300, 128, 64), (130, 70, 67)):
        p, w, g = (torch.randn(math.prod(s) + 1, generator=gen, device=cuda).to(dtype)[1:].view(s)
                   for s in ((l, d), (d, o), (l, o)))
        assert all(t.data_ptr() % 16 for t in (p, w, g))
        fwd, dp, dw = _add2d_bounds(p, w, g, dtype)
        ref = A.add2d_matmul_plain(p, w)
        _within(A.add2d_matmul(p, w), ref, fwd(ref), "forward")
        ref = A.add2d_bwd_dp_plain(p, w, g)
        _within(A.add2d_bwd_dp(p, w, g), ref, dp(ref), "dp")
        ref = A.add2d_bwd_dw_plain(p, w, g)
        _within(A.add2d_bwd_dw(p, w, g), ref, dw(ref), "dw")


def test_add2d_autograd_matches_plain(cuda):
    """Add2dMatmul's gradients on the card against autograd through the plain forward
    (abs differentiates to sign), float32, at a ragged shape."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    p, w, g = (torch.randn(*s, generator=gen, device=cuda) for s in ((77, 45), (45, 19), (77, 19)))
    p1, w1 = p.clone().requires_grad_(), w.clone().requires_grad_()
    A.Add2dMatmul.apply(p1, w1).backward(g)
    p2, w2 = p.clone().requires_grad_(), w.clone().requires_grad_()
    (-(p2[:, :, None] - w2[None]).abs().sum(1)).backward(g)
    _, dp, dw = _add2d_bounds(p, w, g, torch.float32)
    _within(p1.grad, p2.grad, dp(p2.grad), "dp")
    _within(w1.grad, w2.grad, dw(w2.grad), "dw")


def _involution_bwd_routes():
    """Each backward route's wrappers and launch counters."""
    return {
        "tiled": (V.involution_bwd_dxp, V.involution_bwd_dkern, V.KERNEL_DXP, V.KERNEL_DKERN),
        "general": (V.involution_bwd_dxp_general, V.involution_bwd_dkern_general, V.KERNEL_DXP_GENERAL,
                    V.KERNEL_DKERN_GENERAL),
    }


def _involution_bwd_matches_plain(cuda, n, h, w, c, g, k, dtype, route):
    """dxp: the same tap order and roundings, so equal. dkern: the group's channels are
    summed in another order (tiled: four partial sums of fused multiply-adds; general: a
    warp butterfly where cg divides 32, else in order): within 1e-5 of sum |xp * g| over
    the group, plus one bf16 rounding of each side. Only the route's two counters move."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=cuda).to(dtype)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=cuda).to(dtype)
    gout = torch.randn(n, h, w, c, generator=gen, device=cuda).to(dtype)
    routes = _involution_bwd_routes()
    counters = [kernel for *_, dxp_k, dkern_k in routes.values() for kernel in (dxp_k, dkern_k)]
    before = [kernel.launches for kernel in counters]
    dxp_fn, dkern_fn, dxp_k, dkern_k = routes[route]
    dxp, dkern = dxp_fn(xp, kern, gout, k, g), dkern_fn(xp, kern, gout, k, g)
    torch.cuda.synchronize()
    moved = {id(dxp_k), id(dkern_k)}
    assert [kernel.launches - b for kernel, b in zip(counters, before)] == [
        int(id(kernel) in moved) for kernel in counters]
    torch.testing.assert_close(dxp, V.involution_bwd_dxp_plain(xp, kern, gout, k, g), rtol=0, atol=0)
    ref = V.involution_bwd_dkern_plain(xp, kern, gout, k, g)
    absterms = V.involution_bwd_dkern_plain(xp.float().abs(), kern.float(), gout.float().abs(), k, g)
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    _within(dkern, ref, 1e-5 * absterms + ulp * ref.float().abs(), "dkern")


@pytest.mark.parametrize("n,h,w,c,g,k", _INVOLUTION_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_involution_backward_kernels_match_plain(cuda, n, h, w, c, g, k, dtype):
    """Through the route bwd_route picks: tiled where a group is whole 16-byte vectors
    (19 x 37 and 13 x 9 cross tile edges that are not multiples of the tile; C 256 in
    2 groups holds 16 or 32 vectors a group), general for cg = 4 in bf16 and cg = 1."""
    _involution_bwd_matches_plain(cuda, n, h, w, c, g, k, dtype, V.bwd_route(c, g, dtype))


@pytest.mark.parametrize("n,h,w,c,g,k", [(2, 19, 37, 64, 4, 7), (2, 6, 6, 64, 4, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_involution_general_backward_matches_plain_at_tiled_shapes(cuda, n, h, w, c, g, k, dtype):
    """The general route takes any shape: held to the same tolerances where the tiled
    route would be picked."""
    _involution_bwd_matches_plain(cuda, n, h, w, c, g, k, dtype, "general")


def test_involution_backward_wrappers_refuse_what_they_do_not_take(cuda):
    """Every backward wrapper refuses float16 and operands off one CUDA device; the
    tiled ones also refuse a shape whose groups are not whole 16-byte vectors and
    tensors of 2^31 elements or more (checked on the shapes, before any copy). Nothing
    launches."""
    routes = _involution_bwd_routes()
    counters = [kernel for *_, dxp_k, dkern_k in routes.values() for kernel in (dxp_k, dkern_k)]
    before = [kernel.launches for kernel in counters]
    n, h, w, c, g, k = 1, 4, 4, 32, 4, 3
    xp, kern, gout = (torch.zeros(s, device=cuda) for s in ((n, h + k - 1, w + k - 1, c), (n, h, w, k * k * g),
                                                            (n, h, w, c)))
    for dxp_fn, dkern_fn, _, _ in routes.values():
        for fn in (dxp_fn, dkern_fn):
            with pytest.raises(TypeError):
                fn(xp.half(), kern.half(), gout.half(), k, g)
            with pytest.raises(ValueError):
                fn(xp, kern, gout.cpu(), k, g)  # the cotangent on the CPU
    bf = [t.to(torch.bfloat16) for t in (xp, torch.zeros(n, h, w, k * k * 8, device=cuda), gout)]  # G = 8: cg = 4, 8 bytes
    huge_n = 2**31 // ((h + k - 1) * (w + k - 1) * c) + 1
    huge = [t.expand(huge_n, *t.shape[1:]) for t in (xp, kern, gout)]  # stride 0: no memory behind them
    for fn in routes["tiled"][:2]:
        with pytest.raises(ValueError, match="16-byte"):
            fn(*bf, k, 8)
        with pytest.raises(ValueError, match="32 bits"):
            fn(*huge, k, g)
    torch.cuda.synchronize()
    assert [kernel.launches for kernel in counters] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_involution_tiled_kernels_take_views_off_16_byte_boundaries(cuda, dtype):
    """Contiguous views that start one element into their storage: the tiled forward and
    dxp equal their plain versions bit for bit, and dkern stays within its tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    n, h, w, c, g, k = 2, 9, 11, 64, 4, 3
    shapes = ((n, h + k - 1, w + k - 1, c), (n, h, w, k * k * g), (n, h, w, c))
    xp, kern, gout = (torch.randn(math.prod(s) + 1, generator=gen, device=cuda).to(dtype)[1:].view(s)
                      for s in shapes)
    assert all(t.data_ptr() % 16 for t in (xp, kern, gout))
    assert torch.equal(V.involution_stencil_tiled(xp, kern, k, g), V.involution_stencil_plain(xp, kern, k, g))
    assert torch.equal(V.involution_bwd_dxp(xp, kern, gout, k, g), V.involution_bwd_dxp_plain(xp, kern, gout, k, g))
    ref = V.involution_bwd_dkern_plain(xp, kern, gout, k, g)
    absterms = V.involution_bwd_dkern_plain(xp.float().abs(), kern.float(), gout.float().abs(), k, g)
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    _within(V.involution_bwd_dkern(xp, kern, gout, k, g), ref, 1e-5 * absterms + ulp * ref.float().abs(), "dkern")


def test_involution_autograd_matches_plain(cuda):
    """InvolutionStencil's gradients on the card against autograd through the plain
    forward, float32."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n, h, w, c, g, k = 2, 7, 6, 32, 4, 3
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=cuda)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=cuda)
    gout = torch.randn(n, h, w, c, generator=gen, device=cuda)
    a, b = xp.clone().requires_grad_(), kern.clone().requires_grad_()
    V.InvolutionStencil.apply(a, b, k, g).backward(gout)
    a2, b2 = xp.clone().requires_grad_(), kern.clone().requires_grad_()
    V.involution_stencil_plain(a2, b2, k, g).backward(gout)
    torch.testing.assert_close(a.grad, a2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.grad, b2.grad, rtol=1e-5, atol=1e-5)


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    p = torch.zeros(4, 3, device=cuda)
    w = torch.zeros(3, 2, device=cuda)
    with pytest.raises(ValueError):
        A.add2d_matmul(p, w.cpu())
    with pytest.raises(TypeError):
        A.add2d_matmul(p, w.half())
    xp = torch.zeros(1, 4, 4, 4, device=cuda)
    kern = torch.zeros(1, 2, 2, 9 * 2, device=cuda)
    with pytest.raises(ValueError):
        V.involution_bwd_dxp(xp, kern, torch.zeros(1, 2, 2, 3, device=cuda), 3, 2)


@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("u8", [False, True], ids=["logits", "uint8_softmax"])
def test_deploy_forward_graph_equals_eager(cuda, form, u8):
    """``deploy_forward``'s CUDA graph replays equal the eager forward bit for bit at
    each bucket and at a batch of 3 (padded to 4 with its last sample), in the float
    and the int8 form (per-call activation scales, float32 output), for the bench's
    NCHW input and the service's uint8 input with softmax, after the memory freed
    since the capture was overwritten; the int8 kernels launch in the warm-ups and the
    captures, and a replay launches none from Python."""
    from holocron_tpu_torch import quant
    from holocron_tpu_torch.models import RepVGG
    from holocron_tpu_torch.models.core import WARMUP, deploy_forward, softmax_forward
    from holocron_tpu_torch.models.presets import IMAGENETTE

    gen = torch.Generator().manual_seed(21)
    model = RepVGG([1, 1], [16, 32], 1.0, 1.0, generator=gen, device="cpu").eval().reparametrize()
    model = model.to(cuda).to(memory_format=torch.channels_last)
    if form == "int8":
        model = quant.quantize_model(model, min_in_channels=16)
    mean_std = (IMAGENETTE.mean, IMAGENETTE.std) if u8 else None
    buckets, size = (1, 2, 4, 8), 32
    before = (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches)
    graph = deploy_forward(model, buckets, size, mean_std)
    layers = sum(isinstance(m, quant.QuantizedConv2d) for m in model.modules())
    captured = (INT8_KERNEL.launches - before[0], Q.KERNEL_QUANTIZE.launches - before[1])
    assert captured == ((WARMUP + 1) * len(buckets) * layers,) * 2  # the warm-ups and the capture a bucket
    # memory freed since the capture, filled with NaN: the graphs read none of it (the
    # forward holds its mean and std, as the model's weights)
    junk = [torch.full((1, 3, 1, 1), float("nan"), device=cuda) for _ in range(256)]
    if u8:
        mean, std = (torch.tensor(v, device=cuda).reshape(1, 3, 1, 1) for v in mean_std)
        eager = lambda x: softmax_forward(model, x, mean, std)  # noqa: E731
    else:
        eager = model
    dgen = torch.Generator(device=cuda).manual_seed(22)
    for n in (1, 2, 3, 4, 8):
        if u8:
            x = torch.randint(0, 256, (n, size, size, 3), generator=dgen, device=cuda, dtype=torch.uint8)
        else:
            x = torch.randn(n, 3, size, size, generator=dgen, device=cuda).contiguous(memory_format=torch.channels_last)
        launches = (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches)
        got = graph(x).clone()
        assert (INT8_KERNEL.launches, Q.KERNEL_QUANTIZE.launches) == launches
        pad = 4 - n if n == 3 else 0
        with torch.no_grad():
            want = eager(torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]))[:n]
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), n
    with pytest.raises(ValueError):
        graph(x[:1].expand(9, *x.shape[1:]))
    del junk


def test_micro_batcher_works_on_its_own_stream_on_the_card(cuda):
    """The service's batcher given ``device="cuda"`` (no index, as HOLOCRON_DEVICE's
    default reads) runs its model calls on that device and on a stream of its own."""
    import numpy as np

    from holocron_tpu_torch.api.batcher import MicroBatcher

    seen = []

    def infer(batch):
        stream = torch.cuda.current_stream()
        seen.append((torch.cuda.current_device(), stream != torch.cuda.default_stream()))
        return torch.from_numpy(batch).to("cuda").mul(2).cpu().numpy()

    b = MicroBatcher(infer, max_batch=2, max_wait_ms=1, device="cuda")
    try:
        out = b.submit(np.ones((2, 3), np.float32))
    finally:
        b.close()
    assert seen == [(torch.cuda.current_device(), True)]
    assert out["batch_size"] == 1 and (out["probs"] == 2).all()


def _raw_detections(device, n: int = 2, k: int = 3000, num_classes: int = 5, seed: int = 31):
    """Random raw detector outputs on ``device``: overlapping boxes, objectness around
    the 0.5 gate, and scores with ties (a few values only)."""
    gen = torch.Generator().manual_seed(seed)
    boxes = torch.rand(n, k, 4, generator=gen) * 0.8
    boxes[..., 2:] = boxes[..., :2] + torch.rand(n, k, 2, generator=gen) * 0.2 + 0.01
    b_o = torch.rand(n, k, generator=gen) * 0.6 + 0.4
    b_scores = torch.randint(1, 4, (n, k, num_classes), generator=gen).float() / 4
    return boxes.to(device), b_o.to(device), b_scores.to(device)


def test_post_process_on_the_card_equals_the_cpu(cuda):
    """``post_process`` (stable sort, the top 1024 of 3,000 candidates, the greedy NMS
    pass) on the card gives the CPU's boxes, scores, labels and keep masks on the same
    arrays, ties included."""
    from holocron_tpu_torch.models.detection import post_process

    raw = _raw_detections(cuda)
    got = post_process(*raw, 0.5, 0.05)
    want = post_process(*(t.cpu() for t in raw), 0.5, 0.05)
    torch.cuda.synchronize()
    for key in ("boxes", "scores", "labels", "keep"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert 0 < int(want["keep"].sum()) < want["keep"].numel()


def test_yolov4_forward_and_post_process_graph_equals_eager(cuda):
    """yolov4 (a narrow layout, 3 classes, 128 px, random prediction convs), its raw
    forward and ``post_process`` captured together by ``deploy_forward`` at buckets 2
    and 4: each replay's boxes, scores, labels and keep masks equal the eager forward's
    bit for bit, at a full bucket and at a batch of 3 padded to 4."""
    from holocron_tpu_torch.models import detection
    from holocron_tpu_torch.models.core import deploy_forward
    from holocron_tpu_torch.models.detection import post_process

    gen = torch.Generator().manual_seed(32)
    model = detection.YOLOv4([(8, 1), (16, 2), (32, 1), (64, 1), (64, 1)], num_classes=3, generator=gen,
                             device="cpu")
    with torch.no_grad():
        for conv in model.head.pred_convs():
            conv.weight.normal_(0, 0.05, generator=gen)
    model = model.to(cuda).to(memory_format=torch.channels_last).eval()

    def full(x):
        return post_process(*(t.float() for t in model.raw(x)), 0.5, 0.05, obj_thresh=0.3)

    graph = deploy_forward(model, (2, 4), 128, forward=full)
    dgen = torch.Generator(device=cuda).manual_seed(33)
    for n in (4, 3):
        x = torch.randn(n, 3, 128, 128, generator=dgen, device=cuda).contiguous(memory_format=torch.channels_last)
        got = {k: v.clone() for k, v in graph(x).items()}
        with torch.no_grad():
            want = full(torch.cat([x, x[-1:].expand(4 - n, *x.shape[1:])]))
        torch.cuda.synchronize()
        for key in ("boxes", "scores", "labels", "keep"):
            assert torch.equal(got[key], want[key][:n]), (n, key)
        assert int(got["keep"].sum()) > 0


@pytest.mark.parametrize("o", [255, 125], ids=["yolov4_pred", "yolov2_head"])
@pytest.mark.parametrize("c,hw", [(256, 76), (1024, 13)])
def test_int8_route_at_detector_prediction_widths(cuda, o, c, hw):
    """The detectors' prediction convs on the wgmma route: 1x1 convs to 255 (yolov4,
    3 x (5 + 80)) and 125 (yolov2, 5 x (5 + 20)) outputs, from 256 channels at 76 x 76
    and 1,024 at 13 x 13: exact accumulators, outputs within an ulp of the plain
    epilogue."""
    gen = torch.Generator(device=cuda).manual_seed(34)
    x = torch.randn(2, hw, hw, c, generator=gen, device=cuda).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (1, 1, c, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, 1, 0, 1, 35)


@pytest.mark.parametrize(
    "n,hw,c,o,ksize",
    [
        (2, 64, 320, 320, 3),   # a UNet3+ decoder row's block: 5 x 64 channels
        (2, 16, 1024, 64, 3),   # the bottom encoder feature's projection (before its upsampling)
        (2, 64, 320, 21, 1),    # the 1x1 head to 21 classes: the masked epilogue
        (2, 32, 512, 64, 3),    # a skip's projection, biased, no norm after it
    ],
)
def test_int8_route_at_unet3p_geometries(cuda, n, hw, c, o, ksize):
    """unet3p's new int8 geometries on the wgmma route (with and without bias), batch 2:
    exact accumulators, outputs within an ulp of the plain epilogue."""
    gen = torch.Generator(device=cuda).manual_seed(36)
    x = torch.randn(n, hw, hw, c, generator=gen, device=cuda).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, 1, ksize // 2, 1, 37)


def test_int8_wgmma_runs_a_batch_beyond_32_bit_indices_in_runs_of_images(cuda):
    """unet3p's batch-32 row-0 projection of the bottom feature: x_q of 32 x 256 x 256 x
    1024 = 2^31 elements, beyond the kernel's 32-bit indices, runs in one call (one count)
    as launches of whole images: its accumulator equals the two halves' (each under the
    bound, one launch), and the last image's equals the plain version's. A single image
    beyond the bound is refused."""
    gen = torch.Generator(device=cuda).manual_seed(38)
    x_q = torch.randint(-127, 128, (32, 256, 256, 1024), generator=gen, device=cuda, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (3, 3, 1024, 64), generator=gen, device=cuda, dtype=torch.int8)
    packed = Q.pack_weights(w_q)
    before = INT8_KERNEL.launches
    acc = int8_conv_acc(x_q, w_q, 1, 1, 1, w_packed=packed)
    torch.cuda.synchronize()
    assert INT8_KERNEL.launches == before + 1
    for half in (slice(0, 16), slice(16, 32)):
        assert torch.equal(acc[half], int8_conv_acc(x_q[half], w_q, 1, 1, 1, w_packed=packed))
    assert torch.equal(acc[31:], int8_conv_acc_plain(x_q[31:], w_q, 1, 1, 1))
    del x_q, acc
    big = torch.zeros(1, 1024, 1024, 1040, dtype=torch.int8, device=cuda)
    w1 = torch.zeros(1, 1, 1040, 16, dtype=torch.int8, device=cuda)
    before = INT8_KERNEL.launches
    with pytest.raises(RuntimeError, match="int8_conv_wgmma_forward"):
        int8_conv_acc(big, w1, 1, 0, 1)
    assert INT8_KERNEL.launches == before


def _small_unet(arch: str):
    from holocron_tpu_torch.models import segmentation

    kwargs = {"num_classes": 21, "generator": torch.Generator().manual_seed(39), "device": "cpu"}
    if arch == "unet3p":
        return segmentation.UNet3p((8, 16, 32, 64, 128), **kwargs)
    if arch == "unet-transposed-conv":
        return segmentation.UNet((8, 16, 32, 64), bilinear_upsampling=False, **kwargs)
    return segmentation.unet_rexnet13(**kwargs)


@pytest.mark.parametrize("arch", ["unet3p", "unet-transposed-conv", "unet_rexnet13"])
def test_segmentation_forward_on_the_card_equals_the_cpu(cuda, arch):
    """Narrow UNet3+ and UNet (its transposed conv) at 32 px and the full unet_rexnet13
    (pixel shuffles, the UBlocks' nearest shrink at 40 px), float32 eval logits on the
    card (channels_last, TF32 off) within 1e-4 of the CPU's largest magnitude."""
    model = _small_unet(arch).eval()
    size = 40 if arch == "unet_rexnet13" else 32
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(40))
    with torch.no_grad():
        ref = model(x)
        card = model.to(cuda).to(memory_format=torch.channels_last)
        out = card(x.to(cuda).contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (2, 21, size, size)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_segmentation_evaluate_on_the_card_equals_the_cpu(cuda):
    """``SegmentationTrainer.evaluate`` on given logits (an identity model; 21 classes,
    255 in a fifth of the targets): the card's confusion matrix gives the CPU's metrics
    exactly, and its val loss within 1e-5."""
    from holocron_tpu_torch.nn.functional import cross_entropy
    from holocron_tpu_torch.trainer import SegmentationTrainer

    gen = torch.Generator().manual_seed(41)
    batches = []
    for _ in range(3):
        target = torch.randint(0, 21, (4, 32, 32), generator=gen)
        target[torch.rand(target.shape, generator=gen) < 0.2] = 255
        batches.append((torch.randn(4, 21, 32, 32, generator=gen), target))

    def criterion(out, tgt):
        return cross_entropy(out.permute(0, 2, 3, 1), tgt, ignore_index=255)

    metrics = {dev: SegmentationTrainer(torch.nn.Identity(), None, batches, criterion, None, device=dev,
                                        num_classes=21).evaluate() for dev in ("cpu", cuda)}
    assert metrics["cpu"]["acc_global"] == metrics[cuda]["acc_global"]
    assert metrics["cpu"]["mean_iou"] == metrics[cuda]["mean_iou"]
    assert abs(metrics["cpu"]["val_loss"] - metrics[cuda]["val_loss"]) <= 1e-5 * metrics["cpu"]["val_loss"]


def test_upsample_beyond_32_bit_indices_runs_in_runs_of_images(cuda):
    """unet3p's bottom feature at batch 32 (1024 channels, 16 x 16) upsampled 16x in
    bf16 channels_last: 2^31 output elements, beyond torch's bilinear kernel, run in two
    runs of 16 images, equal to each half upsampled alone."""
    import importlib

    unet = importlib.import_module("holocron_tpu_torch.models.segmentation.unet")
    gen = torch.Generator(device=cuda).manual_seed(42)
    x = torch.randn(32, 1024, 16, 16, generator=gen, device=cuda).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    out = unet.upsample2d(x, 16)
    assert out.shape == (32, 1024, 256, 256) and out.is_contiguous(memory_format=torch.channels_last)
    for half in (slice(0, 16), slice(16, 32)):
        assert torch.equal(out[half], unet.upsample2d(x[half], 16))


@pytest.mark.parametrize(
    "n,hw,c,o,ksize,stride",
    [
        (2, 56, 96, 192, 2, 2),     # convnext_tiny's downsamples: 2x2 stride 2, no padding
        (2, 28, 192, 384, 2, 2),
        (2, 14, 384, 768, 2, 2),
        (2, 7, 768, 3072, 1, 1),    # its widest 1x1 pair
        (2, 7, 3072, 768, 1, 1),
        (2, 7, 512, 1280, 1, 1),    # mobileone_s1's last pointwise conv
        (2, 14, 192, 512, 1, 1),    # and its stage-3 entry
    ],
)
def test_int8_route_at_mobileone_and_convnext_geometries(cuda, n, hw, c, o, ksize, stride):
    """The int8 geometries the MobileOne and ConvNeXt serving paths add, on the wgmma
    route, batch 2: exact accumulators, outputs within an ulp of the plain epilogue."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    x = torch.randn(n, hw, hw, c, generator=gen, device=cuda).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    _int8_route_matches_plain(cuda, x, w_q, stride, 0, 1, 44)


@pytest.mark.parametrize("name", ["LARS", "RaLars", "Adan", "AdEMAMix", "Lookahead", "Scout"])
def test_optimizer_step_reads_nothing_from_the_card(cuda, name):
    """Three steps of each new optimizer (the wrappers around AdamP, syncing every other
    step) on card parameters under ``torch.cuda.set_sync_debug_mode("error")``: no step
    waits on the device; the parameters move and stay finite. Adan with amsgrad and
    decay, LARS with Nesterov momentum and decay."""
    from holocron_tpu_torch import optim

    gen = torch.Generator(device=cuda).manual_seed(45)
    params = [torch.nn.Parameter(torch.randn(s, generator=gen, device=cuda)) for s in ((64, 32), (32,), (5, 3, 3, 3))]
    build = {
        "LARS": lambda p: optim.LARS(p, 1e-2, momentum=0.9, weight_decay=1e-4, nesterov=True),
        "RaLars": lambda p: optim.RaLars(p, 1e-2, weight_decay=1e-4),
        "Adan": lambda p: optim.Adan(p, 1e-2, weight_decay=1e-2, amsgrad=True),
        "AdEMAMix": lambda p: optim.AdEMAMix(p, 1e-2, weight_decay=1e-2),
        "Lookahead": lambda p: optim.Lookahead(optim.AdamP(p, 1e-2), sync_period=2),
        "Scout": lambda p: optim.Scout(optim.AdamP(p, 1e-2), sync_period=2),
    }[name]
    opt = build(params)
    before = [p.detach().clone() for p in params]
    for _ in range(3):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(p).all()) and not torch.equal(p, b) for p, b in zip(params, before))


@pytest.mark.parametrize("c,o,ksize,stride,groups", [(48, 48, 3, 1, 1), (20, 40, 1, 1, 1), (64, 96, 3, 2, 1),
                                                     (128, 128, 3, 1, 2)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_custom_ops_launch_the_kernels_and_equal_the_plain_versions(cuda, c, o, ksize, stride, groups,
                                                                         out_dtype):
    """``holocron_tpu_torch::int8_quantize`` and ``::int8_conv`` on CUDA tensors run the
    kernels (each counter moves by one: the conv's route by ``conv_route``) and equal
    the plain versions: the quantization bit for bit, the int32 accumulator exactly
    (float32 output bit for bit, bf16 within one ulp of the plain epilogue's float32
    value, as ``test_int8_conv_*`` hold the wrappers)."""
    gen = torch.Generator(device=cuda).manual_seed(c + o)
    x = torch.randn(2, 9, 11, c, generator=gen, device=cuda)
    s_x = (x.abs().amax() / 127).float().reshape(())
    w_q = torch.randint(-127, 128, (ksize, ksize, c // groups, o), generator=gen, device=cuda, dtype=torch.int8)
    scale, bias = torch.rand(o, generator=gen, device=cuda) * 1e-2, torch.randn(o, generator=gen, device=cuda)
    route = Q.KERNEL if Q.conv_route(c // groups, o, groups) == "wgmma" else Q.KERNEL_GENERAL
    before = (Q.KERNEL_QUANTIZE.launches, route.launches)
    q = torch.ops.holocron_tpu_torch.int8_quantize(x, s_x)
    y = torch.ops.holocron_tpu_torch.int8_conv(q[..., :c], w_q, s_x, scale, bias, [stride] * 2, [ksize // 2] * 2,
                                               [1, 1], groups, out_dtype, None)
    torch.cuda.synchronize()
    assert (Q.KERNEL_QUANTIZE.launches, route.launches) == (before[0] + 1, before[1] + 1)
    assert q.shape[-1] == Q.channel_pitch(c) and torch.equal(q[..., :c], Q.quantize_activation_plain(x, s_x))
    assert torch.equal(q[..., c:], torch.zeros_like(q[..., c:]))
    plain = int8_conv_plain(q[..., :c].cpu(), w_q.cpu(), s_x.cpu(), scale.cpu(), bias.cpu(), stride, ksize // 2, 1,
                            torch.float32, groups)
    if out_dtype == torch.float32:
        assert torch.equal(y.cpu(), plain)
    else:
        torch.testing.assert_close(y.float().cpu(), plain, rtol=2**-8, atol=0)


def test_exported_int8_program_equals_eager_on_the_card(cuda, tmp_path):
    """A small RepVGG's selective-int8 form (bf16 remainder, per-call scales) exported,
    saved and loaded: its graph holds both ops once a layer, its run on the card
    launches the kernels through them, and its logits equal the eager module's bit for
    bit."""
    from holocron_tpu_torch import export, quant
    from holocron_tpu_torch.models import RepVGG

    model = RepVGG([1, 1], [16, 32], 1.0, 1.0, generator=torch.Generator().manual_seed(31), device="cpu")
    model = model.eval().reparametrize().to(cuda).to(memory_format=torch.channels_last)
    qm = quant.quantize_model(model, min_in_channels=16).to(torch.bfloat16).eval()
    layers = sum(isinstance(m, quant.QuantizedConv2d) for m in qm.modules())
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator(device=cuda).manual_seed(32), device=cuda)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    before = INT8_KERNEL.launches
    rec = export.export(qm, x, tmp_path / "int8.pt2")
    assert rec["custom_ops"] == {op: layers for op in export.OPS} and layers == 3
    assert rec["equal"] and INT8_KERNEL.launches - before == 2 * layers  # the eager run and the loaded one
