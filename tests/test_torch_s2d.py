"""Parity of the port's space-to-depth forms of RepVGG with the JAX package, on the CPU.

The JAX package makes the weights; ``holocron_tpu_torch.convert`` carries them across.
Covers ``fold_s2d_kernel``, ``reparametrize(s2d_stem=, s2d_input=)`` and the int8
``s2d_strided`` rewrite. Inputs come from numpy with a fixed seed; the port takes NCHW,
JAX NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu import quant as jquant
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu.models.utils import fold_s2d_kernel as jax_fold_s2d_kernel
from holocron_tpu.transforms.functional import space_to_depth_batch as jax_space_to_depth_batch
from holocron_tpu_torch import convert, quant
from holocron_tpu_torch.kernels.int8_conv import int8_conv_acc
from holocron_tpu_torch.models import RepVGG
from holocron_tpu_torch.models.utils import fold_s2d_kernel, space_to_depth_padded
from holocron_tpu_torch.nn.functional import concat_downsample2d
from holocron_tpu_torch.transforms.functional import space_to_depth_batch

torch.set_num_threads(2)

CFG = ([1, 1], [8, 16], 1.0, 2.0)  # test_models_classification.py's s2d configuration
NUM_CLASSES = 5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def trained():
    """The JAX train-form model after one BN-adapting forward, and a batch."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = Model(JaxRepVGG(*CFG, num_classes=NUM_CLASSES)).init(x.shape, key=jax.random.key(0))
    jm(x, train=True)
    return jax.tree.map(np.asarray, jm.variables), jm.module, x


def _port(variables, **reparam):
    pm = RepVGG(*CFG, num_classes=NUM_CLASSES, device="cpu")
    pm.load_state_dict(convert.repvgg_state_dict(variables))
    return pm.reparametrize(**reparam).eval()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fold_s2d_kernel_equals_jax(dtype):
    """The port's OIHW fold is the JAX HWIO fold transposed, exactly; the unused taps
    are zero."""
    rng = np.random.default_rng(1)
    if dtype == "int8":
        k3 = rng.integers(-127, 128, size=(3, 3, 6, 10)).astype(np.int8)
    else:
        k3 = rng.normal(size=(3, 3, 6, 10)).astype(np.float32)
    theirs = np.asarray(jax_fold_s2d_kernel(jnp.asarray(k3)))
    ours = fold_s2d_kernel(torch.from_numpy(k3).permute(3, 2, 0, 1))
    assert ours.shape == (10, 24, 2, 2) and ours.dtype == torch.from_numpy(k3).dtype
    np.testing.assert_array_equal(ours.permute(2, 3, 1, 0).numpy(), theirs)
    # (u = 0, a = 0): channels of a = 0 in the top row, (v = 0, b = 0) in the left column
    assert not ours[:, :12, 0].any() and not ours[:, 0:6, :, 0].any() and not ours[:, 12:18, :, 0].any()


def test_space_to_depth_padded_layout():
    """One copy: concat_downsample2d's channel order, a zero row on top and a zero
    column on the left, and zero channels up to the pitch."""
    for dtype, c, pitch in ((torch.float32, 3, 16), (torch.int8, 8, 32), (torch.int8, 6, 32)):
        x = torch.arange(2 * 6 * 4 * c).reshape(2, 6, 4, c).to(dtype)  # int8 C = 8: moved as 8-byte words
        z = space_to_depth_padded(x, pitch=pitch)
        assert z.shape == (2, 4, 3, 4 * c) and z.stride() == (4 * 3 * pitch, 3 * pitch, pitch, 1)
        torch.testing.assert_close(z[:, 1:, 1:], concat_downsample2d(x, 2), rtol=0, atol=0)
        assert not z[:, 0].any() and not z[:, :, 0].any()
        assert not z.as_strided((2, 4, 3, pitch - 4 * c), z.stride(), 4 * c).any()  # the buffer's channels past 4C
        pre = concat_downsample2d(x, 2)
        torch.testing.assert_close(space_to_depth_padded(pre, s2d=False), space_to_depth_padded(x), rtol=0, atol=0)


def test_space_to_depth_batch_equals_jax():
    """The host rearrangement that feeds ``s2d_input`` lays the channels out as JAX's."""
    u8 = np.random.default_rng(2).integers(0, 256, size=(2, 8, 6, 3)).astype(np.uint8)
    np.testing.assert_array_equal(space_to_depth_batch(u8), jax_space_to_depth_batch(u8))
    np.testing.assert_array_equal(space_to_depth_batch(u8), concat_downsample2d(torch.from_numpy(u8), 2).numpy())


@pytest.mark.parametrize("form", ["s2d_stem", "s2d_input"])
def test_s2d_deploy_forms_match_plain_and_jax(trained, form):
    """The folded stem gives the plain deploy form's logits and JAX's s2d form's, at
    the JAX tests' 2e-6; its conv is (O, 12, 2, 2) and only the stem is folded."""
    variables, module, x = trained
    plain = _port(variables)
    pm = _port(variables, **{form: True})
    stem = pm.features[0][0].branches
    assert tuple(stem.weight.shape) == (8, 12, 2, 2) and stem.stride == (1, 1) and stem.padding == (0, 0)
    assert tuple(pm.features[1][0].branches.weight.shape) == (32, 8, 3, 3)
    d_s2d, v_s2d = module.reparametrize(variables, **{form: True})
    assert v_s2d["params"]["features_0_0"]["rep_conv"]["kernel"].shape == (2, 2, 12, 8)
    x_in = space_to_depth_batch(x) if form == "s2d_input" else x
    expected = np.asarray(jax.jit(lambda a: d_s2d.apply(v_s2d, a))(x_in))
    with torch.no_grad():
        ref = plain(_nchw(x)).numpy()
        out = pm(_nchw(x_in)).numpy()
        out_cl = pm(_nchw(x_in).contiguous(memory_format=torch.channels_last)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(out, expected, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(out_cl, out)
    # the JAX deploy variables load into the port's folded model as they are
    pm2 = RepVGG(*CFG, num_classes=NUM_CLASSES, device="cpu").reparametrize(**{form: True})
    pm2.load_state_dict(convert.repvgg_state_dict(v_s2d))
    torch.testing.assert_close(pm2.features[0][0].branches.weight, stem.weight, rtol=0, atol=1e-6)


def test_s2d_errors(trained):
    variables, _, x = trained
    s2d_input = _port(variables, s2d_input=True)
    with torch.no_grad(), pytest.raises(ValueError, match="channels % 4 == 0"):
        s2d_input(_nchw(x))  # a batch not rearranged: 3 channels
    s2d_stem = _port(variables, s2d_stem=True)
    with torch.no_grad(), pytest.raises(ValueError, match="stride 2 and even input H/W"):
        s2d_stem(_nchw(x[:, :31, :31]))
    with pytest.raises(AssertionError, match="already reparametrized"):
        s2d_stem.reparametrize()


def test_s2d_strided_accumulators_equal_the_stride2_conv():
    """The rewrite's int32 accumulators equal the stride-2 conv's, bit for bit, at
    pitched and unpitched widths (C % 16 != 0 and C % 16 == 0)."""
    rng = np.random.default_rng(3)
    for c, o, hw in ((3, 8, 10), (8, 16, 12), (16, 24, 8)):
        x_q = torch.from_numpy(rng.integers(-127, 128, size=(2, hw, hw, c)).astype(np.int8))
        w_q = torch.from_numpy(rng.integers(-127, 128, size=(3, 3, c, o)).astype(np.int8))
        ref = int8_conv_acc(x_q, w_q, 2, 1)
        w2 = quant._fold_hwio(w_q)
        acc = int8_conv_acc(space_to_depth_padded(x_q, pitch=-(-4 * c // 16) * 16), w2, 1, 0)
        assert acc.dtype == torch.int32 and acc.shape == ref.shape
        torch.testing.assert_close(acc, ref, rtol=0, atol=0)


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
def test_s2d_strided_int8_model_matches_jax(trained, calibrated):
    """``quantize_model(s2d_strided=True)``: the stride-2 int8 conv takes the folded
    form; its logits equal the stride-2 route's bit for bit (the same accumulators and
    epilogue) and JAX's ``QuantizedModel(s2d_strided=True)``'s within
    test_torch_quant.py's atol 1e-3, with the same top-1."""
    variables, module, x = trained
    jm = Model(module)
    jm.load_variables(jax.tree.map(jnp.asarray, variables))
    jm.reparametrize()
    pm = _port(variables)
    calib = [x] if calibrated else None
    jq = jquant.quantize_model(jm, calibration_batches=calib, input_shape=x.shape, min_in_channels=8,
                               s2d_strided=True)
    kwargs = {"calibration_batches": [_nchw(x)] if calibrated else None, "min_in_channels": 8}
    pq = quant.quantize_model(pm, s2d_strided=True, **kwargs)
    pq_plain = quant.quantize_model(pm, **kwargs)
    assert pq.s2d_strided and not pq_plain.s2d_strided
    folded = [p for p, m in pq.named_modules() if isinstance(m, quant.QuantizedConv2d) and m.s2d]
    assert folded == ["model.features.1.0.branches"]
    conv = dict(pq.named_modules())[folded[0]]
    assert tuple(conv.kernel_s2d_q.shape) == (2, 2, 32, 32) and conv.kernel_s2d_packed is not None
    batch = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    for b in (x, batch):
        expected = np.asarray(jq(b))
        with torch.no_grad():
            out = pq(_nchw(b)).numpy()
            out_plain = pq_plain(_nchw(b)).numpy()
        np.testing.assert_array_equal(out, out_plain)
        np.testing.assert_allclose(out, expected, atol=1e-3)
        np.testing.assert_array_equal(out.argmax(-1), expected.argmax(-1))
    # an odd input takes the stride-2 conv; the state dict holds kernel_q alone
    with torch.no_grad():
        np.testing.assert_array_equal(pq(_nchw(batch[:, :30, :30])).numpy(), pq_plain(_nchw(batch[:, :30, :30])).numpy())
    assert not any("s2d" in k for k in pq.state_dict())
    # no arch's policy sets s2d_strided: the default stays off
    assert not quant.quantize_model(pm, min_in_channels=8, arch="repvgg_a0").s2d_strided
