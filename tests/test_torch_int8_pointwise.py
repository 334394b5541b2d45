"""The int8 conv's pointwise route (``int8_pointwise_wgmma_kernel``) on the CPU.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py -k
pointwise``); here the Python around it: which layers of the served models take it,
the column tile it launches with, the packed weights it reads through its tensor maps
(rows and reduction bytes past them read as zeros), and a 1x1 ``QuantizedConv2d``
against the JAX package's ``_quantized_conv`` on the same weights.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu import quant as jquant
from holocron_tpu_torch import models, quant
from holocron_tpu_torch.kernels import int8_conv as K
from holocron_tpu_torch.models import detection, segmentation

torch.set_num_threads(2)

# (pointwise, wgmma, halo) int8 convs of each served model as quantize_model selects them
SERVED_ROUTES = {
    "repvgg_a0": (0, 23, 3),
    "resnet50": (33, 19, 0),
    "rexnet1_0x": (44, 0, 0),
    "darknet53": (23, 26, 0),
    "mobileone_s1": (21, 0, 0),
    "convnext_tiny": (36, 3, 0),
    "yolov4": (61, 41, 0),
    "unet3p": (1, 32, 0),
}


def _served(arch: str):
    gen = torch.Generator().manual_seed(0)
    if arch == "yolov4":
        return detection.yolov4(pretrained_backbone=False, num_classes=80, generator=gen, device="cpu")
    if arch == "unet3p":
        return segmentation.unet3p(num_classes=21, generator=gen, device="cpu")
    model = getattr(models, arch)(num_classes=10, generator=gen, device="cpu").eval()
    return model.reparametrize() if hasattr(model, "reparametrize") else model


@pytest.mark.parametrize("arch", list(SERVED_ROUTES))
def test_pointwise_route_at_every_served_int8_layer(arch):
    """Every int8 layer of the served models takes the route its shape gives it: the
    pointwise GEMM exactly where the conv is 1x1, stride 1, unpadded and ungrouped (at
    any C and O: rexnet1_0x's odd widths too), the halo conv where it is KxK, stride 1,
    undilated, ungrouped, O % 8 == 0 and C <= 48, the wgmma conv at every other
    ungrouped one (3x3 of more channels, 2x2 downsamples, 1x1 stride-2 projections), the
    general route at none; every ungrouped layer holds its packed weights."""
    layers = [m for m in quant.quantize_model(_served(arch).eval(), arch=arch).modules()
              if isinstance(m, quant.QuantizedConv2d)]
    routes = [m.route for m in layers]
    assert (routes.count("pointwise"), routes.count("wgmma"), routes.count("halo")) == SERVED_ROUTES[arch]
    for m, route in zip(layers, routes):
        kh, kw, c, o = m.kernel_q.shape
        gemm = (kh, kw) == (1, 1) and tuple(m.stride) == (1, 1) and tuple(m.padding) == (0, 0) and m.groups == 1
        halo = (kh * kw > 1 and tuple(m.stride) == (1, 1) and tuple(m.dilation) == (1, 1) and m.groups == 1
                and o % 8 == 0 and c <= 48)
        assert route == ("pointwise" if gemm else "halo" if halo else "wgmma"), (tuple(m.kernel_q.shape), m.stride)
        assert route == K.conv_route(c, o, m.groups, kernel_size=(kh, kw), stride=m.stride, padding=m.padding)
        assert torch.equal(m.kernel_packed, K.pack_weights(m.kernel_q))


@pytest.mark.parametrize(
    "o,bn",
    [(8, 48), (27, 48), (48, 48), (50, 64), (96, 96), (140, 192), (185, 192), (256, 256), (320, 64), (384, 192),
     (512, 256), (570, 192), (636, 128), (640, 128), (702, 64), (768, 256), (906, 192), (972, 256), (1044, 64),
     (1280, 256), (1536, 256), (2048, 256), (3072, 256)],
)
def test_pointwise_column_tile(o, bn):
    """The pointwise route's column tile: all of O in one tile of the built widths up to
    256 (its smallest that holds O), past it the width of 64, 128, 192 and 256 that pads
    O least, the widest of those that tie: 384 -> 2 x 192 (the wgmma route's 256-wide
    tiles pad it to 512), 320 -> 5 x 64."""
    assert K.pointwise_tile_n(o) == bn
    assert K.pointwise_tile_n(o) == (K.tile_n(o) if o <= 256 else
                                     min(K.POINTWISE_WIDE, key=lambda b: (-(-o // b) * b, -b)))
    tiles = -(-o // bn)
    least = min(-(-o // b) * b for b in K.POINTWISE_WIDE)
    assert o <= 256 and tiles == 1 or bn in K.POINTWISE_WIDE and tiles * bn == least


def test_pointwise_launch_tile_spreads_few_tiles():
    """At launch, a layer of several column tiles with fewer 64-row tiles than SMs
    (rexnet1_0x's SE excitations at M = the batch of 256) takes 64-wide tiles; a layer
    with rows enough keeps its tile, and one column tile keeps its width."""
    sms = 132
    assert [K.pointwise_launch_tile_n(o, 256, sms) for o in (768, 840, 906, 972, 1044)] == [64] * 5
    for o in (27, 185, 384, 768, 1044, 3072):
        assert K.pointwise_launch_tile_n(o, 50176, sms) == K.pointwise_tile_n(o)
    assert K.pointwise_launch_tile_n(192, 256, sms) == 192 and K.pointwise_launch_tile_n(19, 8, sms) == 48


def _pointwise_arithmetic(x_q: torch.Tensor, packed: torch.Tensor, o: int, bn: int) -> torch.Tensor:
    """The pointwise kernel's arithmetic on the CPU: x_q at its pitch as an (M, P) matrix,
    column tiles of ``bn`` rows of the packed weights read through a tensor map of the
    packed matrix (rows past it read as zeros), 128-byte steps of k32 products issued
    only over bytes below P (the bytes of x past P read as zeros), summed in int64."""
    n, h, w, c = x_q.shape
    pitch = K.channel_pitch(c)
    x = x_q.as_strided((n * h * w, pitch), (pitch, 1)).long()
    rows, k_pad = packed.shape
    tiles = []
    for n0 in range(0, o, bn):
        tile = torch.zeros(bn, k_pad, dtype=torch.long)
        tile[: max(0, min(bn, rows - n0))] = packed[n0:n0 + bn].long()
        acc = torch.zeros(x.shape[0], bn, dtype=torch.long)
        for kt in range(0, k_pad, K.STEP_K):
            for kk in range(kt, kt + K.STEP_K, 32):
                if kk >= pitch:  # no product over bytes past P
                    break
                xs = torch.zeros(x.shape[0], 32, dtype=torch.long)
                xs[:, : min(32, pitch - kk)] = x[:, kk:kk + 32]
                acc += xs @ tile[:, kk:kk + 32].T
        tiles.append(acc)
    return torch.cat(tiles, 1)[:, :o].to(torch.int32).reshape(n, h, w, o)


@pytest.mark.parametrize("c,o", [(96, 384), (64, 320), (185, 640), (95, 570), (117, 702), (16, 27), (300, 61),
                                 (3072, 768), (1044, 185), (75, 906)])
def test_pack_weights_feed_the_pointwise_tiles(c, o):
    """``pack_weights`` of a 1x1 kernel, read as the pointwise kernel reads it (column
    tiles of its launch width, which need not divide the packed rows: 384 in 192-wide
    tiles from rows packed for 256-wide ones; the rows past the matrix zero) and
    multiplied by x_q at its pitch step by step, gives ``int8_conv_acc_plain``'s exact
    accumulator; the packing is the wgmma route's, so a layer's packed weights serve
    either route."""
    rng = np.random.default_rng(c * 7 + o)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, c)).astype(np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(1, 1, c, o), dtype=np.int8))
    x_q = K.quantize_activation(x, x.abs().amax() / 127)
    packed = K.pack_weights(w_q)
    assert packed.shape == (-(-o // K.tile_n(o)) * K.tile_n(o), -(-K.channel_pitch(c) // K.STEP_K) * K.STEP_K)
    ref = K.int8_conv_acc_plain(x_q.contiguous(), w_q)
    for bn in {K.pointwise_tile_n(o), K.pointwise_launch_tile_n(o, 256, 132)}:
        assert torch.equal(_pointwise_arithmetic(x_q, packed, o, bn), ref), bn


def test_pointwise_route_refuses_what_it_does_not_take():
    """Forced onto a conv it does not take (3x3, a 1x1 of stride 2 or padding 1, a grouped
    one), the pointwise route raises before anything runs; the wgmma route may be forced
    onto a pointwise conv (the checks time it there), never the general one."""
    x_q = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    for ksize, stride, padding, groups in ((3, 1, 1, 1), (1, 2, 0, 1), (1, 1, 1, 1), (1, 1, 0, 2)):
        w_q = torch.zeros(ksize, ksize, 16 // groups, 8, dtype=torch.int8)
        with pytest.raises(ValueError, match="the pointwise route"):
            K._launch(x_q, w_q, None, None, None, None, stride, padding, 1, torch.int32, groups, route="pointwise")
    with pytest.raises(ValueError, match="the wgmma route"):
        K._launch(x_q, torch.zeros(3, 3, 8, 8, dtype=torch.int8), None, None, None, None, 1, 1, 1, torch.int32, 2,
                  route="wgmma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_conv2d_1x1_matches_jax(dtype):
    """A 1x1 ``QuantizedConv2d`` of convnext_tiny's first expansion width (C = 96 -> O =
    384, biased, a calibrated activation scale) against the JAX package's
    ``_quantized_conv`` (``holocron_tpu/quant.py:228-275``) on the same int8 weights,
    scales and input: the quantized activation, the int32 accumulator and the float32
    epilogue are the same arithmetic in the same order, so the outputs are equal (in
    bf16, the same roundings of equal float32 values, the bias as the bf16 form holds
    it)."""
    rng = np.random.default_rng(19)
    c, o = 96, 384
    x = rng.normal(size=(2, 7, 6, c)).astype(np.float32)
    kernel_q = rng.integers(-127, 128, size=(1, 1, c, o), dtype=np.int8)
    w_scale = rng.uniform(1e-3, 1e-2, size=o).astype(np.float32)
    bias = rng.normal(size=o).astype(np.float32)
    absmax = float(np.abs(x).max())

    jconv = fnn.Conv(o, (1, 1), use_bias=True, dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    # the port's bf16 form holds its bias in bf16 (``.to(torch.bfloat16)`` casts the float
    # remainder): JAX is handed the same rounded values, which it adds in float32 as the port does
    jbias = torch.from_numpy(bias).to(dtype).float().numpy()
    bound = jconv.bind({"params": {"kernel": jnp.asarray(kernel_q, jnp.float32), "bias": jnp.asarray(jbias)}})
    xj = jnp.asarray(x) if dtype == torch.float32 else jnp.asarray(x).astype(jnp.bfloat16)
    want = jquant._quantized_conv(bound, xj, {"kernel_q": jnp.asarray(kernel_q), "w_scale": jnp.asarray(w_scale)},
                                  absmax)

    conv = torch.nn.Conv2d(c, o, 1, device="cpu")
    with torch.no_grad():
        conv.bias.copy_(torch.from_numpy(bias))
    m = quant.QuantizedConv2d(conv, torch.from_numpy(kernel_q), torch.from_numpy(w_scale), absmax).to(dtype)
    assert m.route == "pointwise"
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    with torch.no_grad():
        got = m(xt).permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))
