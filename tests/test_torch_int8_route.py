"""The int8 conv's routes, its packed weights and its quantization, on the CPU.

The CUDA kernels themselves are held against their plain versions in
``tests/test_torch_kernels_cuda.py``; here the Python around them: which route a shape
takes, the packed (O, K) weights the wgmma route reads, ``QuantizedConv2d``'s packed
buffer, and the plain quantization against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu import quant as jquant
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu_torch import convert, quant
from holocron_tpu_torch.kernels import int8_conv as K
from holocron_tpu_torch.models import RepVGG, repvgg_a0

torch.set_num_threads(2)

# (C, O, stride) of the 26 int8 convs of repvgg_a0, and how many of each
REPVGG_A0_INT8 = {(48, 48, 1): 3, (48, 48, 2): 1, (48, 96, 2): 1, (96, 96, 1): 4, (96, 192, 2): 1,
                  (192, 192, 1): 14, (192, 1280, 2): 1, (1280, 1280, 1): 1}


@pytest.mark.parametrize(
    "kh,kw,c,o",
    [(3, 3, 48, 48), (3, 3, 48, 96), (3, 3, 192, 1280), (1, 1, 16, 24), (3, 3, 64, 320), (3, 3, 96, 96), (1, 3, 32, 8)],
)
def test_packed_weights_unpack_to_kernel_q(kh, kw, c, o):
    """Row o of the packed matrix is w_q[..., o] in (r, s, c) order, zero beyond O and K;
    O pads to whole column tiles, K to whole 128-byte steps."""
    rng = np.random.default_rng(0)
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(kh, kw, c, o), dtype=np.int8))
    packed = K.pack_weights(w_q)
    k, bn = kh * kw * c, K.tile_n(o)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (-(-o // bn) * bn, -(-k // K.STEP_K) * K.STEP_K)
    assert packed.shape[1] % 128 == 0 and packed.shape[0] % bn == 0
    unpacked = packed[:o, :k].reshape(o, kh, kw, c).permute(1, 2, 3, 0)
    assert torch.equal(unpacked, w_q)
    assert not packed[o:].any() and not packed[:, k:].any()


def test_route_by_shape():
    """repvgg_a0's int8 convs (3x3): the stride-1 ones of C <= 48 (the three 48 -> 48)
    take the halo route, the others the wgmma route with the layer's whole O as its tile
    (256-wide tiles for 1280), both reading the same packed weights; every other ungrouped conv
    but the 1x1, stride-1, unpadded ones (the pointwise GEMM at any C and O) takes the
    halo route where it is stride-1, undilated, C <= 48 and O % 8 == 0, else the wgmma
    route (C read at its 16-byte pitch, O under a masked epilogue); only grouped convs
    take the general route."""
    model = repvgg_a0(num_classes=10, generator=torch.Generator().manual_seed(0), device="cpu").reparametrize()
    qm = quant.quantize_model(model, arch="repvgg_a0")
    seen, routes = {}, {}
    for m in qm.modules():
        if isinstance(m, quant.QuantizedConv2d):
            _, _, c, o = m.kernel_q.shape
            seen[(c, o, m.stride[0])] = seen.get((c, o, m.stride[0]), 0) + 1
            route = "halo" if m.stride == (1, 1) and c <= 48 else "wgmma"
            assert K.conv_route(c, o, kernel_size=m.kernel_q.shape[:2], stride=m.stride, padding=m.padding) == route
            assert m.route == route
            routes[route] = routes.get(route, 0) + 1
            assert m.kernel_packed is not None and torch.equal(m.kernel_packed, K.pack_weights(m.kernel_q))
    assert seen == REPVGG_A0_INT8
    assert routes == {"halo": 3, "wgmma": 23}
    assert {o: K.tile_n(o) for o in (48, 96, 192, 1280)} == {48: 48, 96: 96, 192: 192, 1280: 256}
    # shapes that took byte-wise staging on the general route before the padded pitch
    # (tests/test_torch_kernels_cuda.py) and the stem's C = 3
    for c, o in ((12, 8), (3, 5), (16, 70), (3, 48), (8, 16), (24, 32)):
        route = "halo" if o % 8 == 0 else "wgmma"
        assert K.conv_route(c, o, kernel_size=3, padding=1) == route, (c, o)
        assert K.conv_route(c, o, kernel_size=1) == "pointwise", (c, o)
    for c, o in ((16, 24), (48, 72), (32, 8), (16, 16), (256, 256)):
        assert K.conv_route(c, o, kernel_size=3, stride=2, padding=1) == "wgmma", (c, o)
        assert K.conv_route(c, o, kernel_size=1, stride=2) == "wgmma", (c, o)  # 1x1 stride 2: not a GEMM over x
        assert K.conv_route(c, o, kernel_size=1, padding=1) == "wgmma", (c, o)
    for c, o, groups in ((64, 2048, 32), (12, 8, 2), (16, 16, 4)):
        assert K.conv_route(c, o, groups, kernel_size=3) == "general", (c, o, groups)
        assert K.conv_route(c, o, groups, kernel_size=1) == "general", (c, o, groups)


def test_quantized_conv2d_packed_buffer_is_not_state():
    """kernel_packed follows kernel_q through a device or dtype move and a state_dict
    load, and is not in the state_dict: the keys and kernel_q's HWIO layout stay."""
    g = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(16, 24, 3, padding=1, device="cpu")
    rec = quant.quantize_conv_params(torch.nn.Sequential(conv), ["0"])["0"]
    m = quant.QuantizedConv2d(conv, rec["kernel_q"], rec["w_scale"], act_absmax=3.0)
    assert set(m.state_dict()) == {"kernel_q", "w_scale", "act_scale", "bias"}
    assert m.state_dict()["kernel_q"].shape == (3, 3, 16, 24)
    assert torch.equal(m.kernel_packed, K.pack_weights(m.kernel_q))
    m = m.to(torch.bfloat16)
    assert m.kernel_packed.dtype == torch.int8 and torch.equal(m.kernel_packed, K.pack_weights(m.kernel_q))
    other = m.state_dict()
    other["kernel_q"] = torch.randint(-127, 128, (3, 3, 16, 24), generator=g, dtype=torch.int8)
    m.load_state_dict(other)
    assert torch.equal(m.kernel_packed, K.pack_weights(other["kernel_q"]))
    small = quant.QuantizedConv2d(torch.nn.Conv2d(3, 8, 3), torch.ones(3, 3, 3, 8, dtype=torch.int8), torch.ones(8))
    assert torch.equal(small.kernel_packed, K.pack_weights(small.kernel_q))  # C = 3 over a 16-byte pitch
    assert small.kernel_packed.shape == (48, 256) and int(small.kernel_packed.sum()) == 3 * 3 * 3 * 8
    grouped = quant.QuantizedConv2d(torch.nn.Conv2d(8, 8, 3, groups=2), torch.zeros(3, 3, 4, 8, dtype=torch.int8),
                                    torch.ones(8))
    assert grouped.kernel_packed is None  # the general route reads kernel_q itself


def test_quantize_activation_equals_jax_on_ties_and_clip():
    """Exactly on the ties (k + 0.5) * s_x (s_x a power of two), one ulp either side,
    at and beyond +-127 * s_x and at zero: the same int8 as JAX's
    ``clip(round(x / s_x), -127, 127)`` (quant.py:244), in float32 and bf16."""
    s = np.float32(2.0**-5)
    k = np.arange(-140, 141, dtype=np.float32)
    ties = (k + np.float32(0.5)) * s
    x = np.concatenate([ties, np.nextafter(ties, np.inf), np.nextafter(ties, -np.inf), k * s,
                        np.array([127.0, -127.0, 127.49, -127.51, 1e6, -1e6, 0.0, -0.0], np.float32) * s])
    for xs, sx in ((x, s), (x / s * np.float32(0.0123), np.float32(0.0123))):
        xs = xs.astype(np.float32)
        expected = np.asarray(jnp.clip(jnp.round(jnp.asarray(xs) / sx), -127, 127).astype(jnp.int8))
        got = K.quantize_activation_plain(torch.from_numpy(xs), torch.tensor(sx))
        np.testing.assert_array_equal(got.numpy(), expected)
        xb = torch.from_numpy(xs).to(torch.bfloat16)
        expected_b = np.asarray(jnp.clip(jnp.round(jnp.asarray(xb.float().numpy()) / sx), -127, 127).astype(jnp.int8))
        np.testing.assert_array_equal(K.quantize_activation(xb, torch.tensor(sx)).numpy(), expected_b)


def test_quantized_conv_cpu_is_the_plain_route():
    """On the CPU, quantized_conv is quantize_activation_plain then int8_conv_plain, with
    or without packed weights, NHWC in and out."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 9, 10, 32)).astype(np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(3, 3, 32, 48), dtype=np.int8))
    s_x = x.abs().amax() / 127
    w_scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, 48).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=48).astype(np.float32))
    ref = K.int8_conv_plain(K.quantize_activation_plain(x, s_x), w_q, s_x, w_scale, bias, 2, 1)
    for packed in (None, K.pack_weights(w_q)):
        out = K.quantized_conv(x, s_x, w_q, w_scale, bias, 2, 1, w_packed=packed)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.fixture(scope="module")
def deployed_wide():
    """A JAX deploy RepVGG whose int8 convs take the halo route (stride 1) and the wgmma
    route (stride 2) on the card (C = 16, 32), the port's copy of it, a calibration batch
    and a held-out batch."""
    cfg = ([1, 1], [16, 32], 1.0, 1.0)
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    held_out = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = Model(JaxRepVGG(*cfg)).init(calib.shape, key=jax.random.key(0))
    jm(calib, train=True)
    jm.reparametrize()
    pm = RepVGG(*cfg, device="cpu").reparametrize()
    pm.load_state_dict(convert.repvgg_state_dict(jax.tree.map(np.asarray, jm.variables)))
    return jm, pm.eval(), calib, held_out


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
def test_int8_model_with_packed_weights_matches_jax(deployed_wide, calibrated):
    """Every int8 conv holds packed weights; logits within atol 1e-3 and the same top-1
    as JAX's QuantizedModel."""
    jm, pm, calib, held_out = deployed_wide
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    jq = jquant.quantize_model(jm, calibration_batches=[calib] if calibrated else None, min_in_channels=16)
    pq = quant.quantize_model(pm, calibration_batches=[nchw(calib)] if calibrated else None, min_in_channels=16)
    int8 = [m for m in pq.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert len(int8) == len(jq.qparams) == 3
    assert all(m.kernel_packed is not None for m in int8)
    for batch in (calib, held_out):
        expected = np.asarray(jq(batch))
        with torch.no_grad():
            out = pq(nchw(batch)).numpy()
        np.testing.assert_allclose(out, expected, atol=1e-3)
        np.testing.assert_array_equal(out.argmax(-1), expected.argmax(-1))
