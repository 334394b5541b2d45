"""The int8 conv's padded channel pitch and the weights packed over it, on the CPU.

A quantized activation lies at a pixel pitch of ``channel_pitch(C)`` (C rounded up to
whole 16-byte copies, zeros beyond C) and every ungrouped conv's weights are packed over
that pitch, so the wgmma route takes any C and O. Here the layout itself: the plain
quantization against JAX's, the packing against ``kernel_q``, the routes of rexnet1_0x's
int8 convs, and a plain GEMM over the padded operands against the exact convolution.
The CUDA kernels are held against the same plain versions in
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from holocron_tpu_torch import models, quant
from holocron_tpu_torch.kernels import int8_conv as K

torch.set_num_threads(2)

# (C, O) of rexnet1_0x's 44 int8 convs (all 1x1, stride 1, ungrouped) at 10 classes
REXNET1_0X_INT8 = [
    (96, 27), (162, 38), (228, 19), (228, 50), (300, 25), (300, 61), (366, 30), (366, 72), (72, 432), (432, 36),
    (432, 84), (84, 504), (504, 42), (504, 95), (95, 570), (570, 47), (570, 106), (106, 636), (636, 53),
    (636, 117), (117, 702), (702, 58), (702, 128), (128, 768), (768, 64), (64, 768), (768, 140), (140, 840),
    (840, 70), (70, 840), (840, 151), (151, 906), (906, 75), (75, 906), (906, 162), (162, 972), (972, 81),
    (81, 972), (972, 174), (174, 1044), (1044, 87), (87, 1044), (1044, 185), (185, 1280),
]


def _pad(q: torch.Tensor) -> torch.Tensor:
    """The channels C .. pitch - 1 of a quantized activation at its pitch."""
    c = q.shape[-1]
    pitch = K.channel_pitch(c)
    assert q.stride()[-1] == 1 and (q.dim() == 1 or q.stride()[-2] == pitch)
    return q.as_strided((*q.shape[:-1], pitch), q.stride())[..., c:]


def test_channel_pitch():
    assert [K.channel_pitch(c) for c in (1, 15, 16, 17, 27, 32, 162, 185, 1044)] == [
        16, 16, 16, 32, 32, 32, 176, 192, 1056]


@pytest.mark.parametrize("c", [1, 3, 12, 16, 27, 48, 162, 185])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_quantization_writes_the_pitch(c, dtype):
    """The first C channels equal JAX's ``clip(round(x / s_x), -127, 127)``
    (quant.py:244), the pad is zero, and at C % 16 == 0 the result is the contiguous
    buffer itself."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy((4 * rng.normal(size=(2, 3, 5, c))).astype(np.float32)).to(dtype)
    s_x = torch.tensor(0.05)
    q = K.quantize_activation_plain(x, s_x)
    expected = np.asarray(jnp.clip(jnp.round(jnp.asarray(x.float().numpy()) / np.float32(0.05)), -127, 127)
                          .astype(jnp.int8))
    assert q.shape == x.shape and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), expected)
    assert q.stride() == (15 * K.channel_pitch(c), 5 * K.channel_pitch(c), K.channel_pitch(c), 1)
    assert not bool(_pad(q).any())
    assert q.is_contiguous() == (c % 16 == 0)
    assert torch.equal(K.quantize_activation(x, s_x), q)


@pytest.mark.parametrize(
    "kh,kw,c,o",
    [(1, 1, 96, 27), (1, 1, 162, 38), (1, 1, 75, 906), (1, 1, 185, 1280), (3, 3, 21, 27), (1, 3, 3, 5),
     (3, 3, 48, 96), (1, 1, 128, 768)],
)
def test_packed_weights_over_the_pitch(kh, kw, c, o):
    """Row o holds w_q[r, s, c, o] at (r * KW + s) * pitch + c, zero at the pad channels
    of every tap, beyond O (whole column tiles) and beyond K (whole 128-byte steps); at
    C % 16 == 0 the packing is the unpadded one, (r * KW + s) * C + c."""
    rng = np.random.default_rng(kh * 1000 + c + o)
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(kh, kw, c, o), dtype=np.int8))
    packed = K.pack_weights(w_q)
    pitch, bn = K.channel_pitch(c), K.tile_n(o)
    k = kh * kw * pitch
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (-(-o // bn) * bn, -(-k // K.STEP_K) * K.STEP_K)
    taps = packed[:o, :k].reshape(o, kh, kw, pitch)
    assert torch.equal(taps[..., :c].permute(1, 2, 3, 0), w_q)
    assert not taps[..., c:].any() and not packed[o:].any() and not packed[:, k:].any()
    if c % 16 == 0:
        assert torch.equal(packed[:o, : kh * kw * c], w_q.permute(3, 0, 1, 2).reshape(o, kh * kw * c))


def test_rexnet1_0x_int8_convs_all_take_the_wgmma_route():
    """The 44 convs ``quantize_model`` selects on rexnet1_0x: every one ungrouped, 1x1,
    stride 1, on the wgmma route with its weights packed over the pitch; 41 of them
    have C % 16 != 0 or O % 8 != 0 (the padded pitch or the masked epilogue), the
    shapes the general route took before. Grouped convs keep the general route."""
    model = models.rexnet1_0x(num_classes=10, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    layers = [m for m in quant.quantize_model(model).modules() if isinstance(m, quant.QuantizedConv2d)]
    shapes = [tuple(m.kernel_q.shape) for m in layers]
    assert [(c, o) for _, _, c, o in shapes] == REXNET1_0X_INT8
    assert all(s[:2] == (1, 1) and m.stride == (1, 1) and m.groups == 1 for s, m in zip(shapes, layers))
    assert [K.conv_route(c, o, m.groups) for (_, _, c, o), m in zip(shapes, layers)] == ["wgmma"] * 44
    assert all(torch.equal(m.kernel_packed, K.pack_weights(m.kernel_q)) for m in layers)
    assert sum(c % 16 != 0 or o % 8 != 0 for c, o in REXNET1_0X_INT8) == 41
    for c, o, groups in ((64, 2048, 32), (8, 4, 3), (3, 7, 5), (32, 64, 2)):
        assert K.conv_route(c, o, groups) == "general", (c, o, groups)


def _gemm_over_padded_operands(x_q: torch.Tensor, packed: torch.Tensor, kh: int, kw: int, o: int, padding: int):
    """The wgmma route's arithmetic as a plain GEMM: the (N, H, W, pitch) buffer under
    x_q unfolded tap by tap in (r, s, c) order (K = KH * KW * pitch) times the packed
    weights' first K columns, in float64 (exact)."""
    n, h, w, c = x_q.shape
    pitch = K.channel_pitch(c)
    buf = x_q.as_strided((n, h, w, pitch), x_q.stride()).permute(0, 3, 1, 2).double()
    cols = F.unfold(buf, (kh, kw), padding=padding)  # (N, pitch * KH * KW, L) in (c, r, s) order
    cols = cols.reshape(n, pitch, kh * kw, -1).transpose(1, 2).reshape(n, kh * kw * pitch, -1)
    acc = packed[:o, : kh * kw * pitch].double() @ cols  # (N, O, L)
    oh, ow = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    return acc.reshape(n, o, oh, ow).permute(0, 2, 3, 1).to(torch.int32)


@pytest.mark.parametrize(
    "c,o,hw,ksize",
    [(96, 27, 7, 1), (162, 38, 5, 1), (1044, 87, 1, 1), (75, 906, 1, 1), (174, 1044, 3, 1), (185, 1280, 3, 1),
     (768, 140, 4, 1), (21, 27, 6, 3), (3, 5, 5, 3)],
)
def test_gemm_over_padded_operands_is_the_conv(c, o, hw, ksize):
    """At rexnet1_0x's geometries (and a 3x3 one of odd C, whose pad lies at every tap):
    the GEMM over the padded x_q and the packed weights equals int8_conv_acc_plain, the
    exact convolution of the unpadded operands; so does the port's CPU route on the
    pitched view and on a contiguous copy."""
    rng = np.random.default_rng(c + o)
    x = torch.from_numpy(rng.normal(size=(3, hw, hw, c)).astype(np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(ksize, ksize, c, o), dtype=np.int8))
    x_q = K.quantize_activation(x, x.abs().amax() / 127)
    padding = ksize // 2
    ref = K.int8_conv_acc_plain(x_q.contiguous(), w_q, 1, padding)
    assert torch.equal(_gemm_over_padded_operands(x_q, K.pack_weights(w_q), ksize, ksize, o, padding), ref)
    assert torch.equal(K.int8_conv_acc(x_q, w_q, 1, padding), ref)


def test_launch_tile_n_spreads_few_wide_tiles():
    """The wgmma route's column tile at launch: the packing's tile, except past 256
    columns where 256-wide tiles would be fewer than the SMs (rexnet1_0x's SE
    excitations at M = 256), which take 64-wide ones; the packed rows hold both."""
    sms = 132
    for o in (27, 185, 256, 768, 1044):
        assert K.launch_tile_n(o, 50176, sms) == K.tile_n(o)
    assert [K.launch_tile_n(o, 256, sms) for o in (768, 840, 906, 972, 1044)] == [64] * 5
    assert K.launch_tile_n(1280, 8 * 49, sms) == 64 and K.launch_tile_n(1280, 256 * 49, sms) == 256
    assert K.launch_tile_n(192, 256, sms) == 192  # a single column tile keeps its width
    for o in (257, 906, 1044, 2048):
        assert K.pack_weights(torch.zeros(1, 1, 16, o, dtype=torch.int8)).shape[0] % 64 == 0
