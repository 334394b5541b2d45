"""Parity of the blocks that plug into the port's ResNet container (Res2Net, SKNet,
TridentNet, PyConvResNet), and of the int8 form of a small ResNeXt, with the JAX
package on the CPU in float32. The harness and its tolerances are
``test_torch_resnet.py``'s."""

import jax
import numpy as np
import pytest
import torch
from test_torch_resnet import check_resnet_parity, nchw, randomize_bn

from holocron_tpu import quant as jquant
from holocron_tpu.models.classification import pyconv_resnet as jax_pyconv
from holocron_tpu.models.classification import res2net as jax_res2net
from holocron_tpu.models.classification import resnet as jax_resnet
from holocron_tpu.models.classification import sknet as jax_sknet
from holocron_tpu.models.classification import tridentnet as jax_tridentnet
from holocron_tpu.models.core import Model
from holocron_tpu.nn.modules.conv import PyConv2d as JaxPyConv2d
from holocron_tpu_torch import convert, quant
from holocron_tpu_torch.kernels.int8_conv import conv_route
from holocron_tpu_torch.models.classification import pyconv_resnet, res2net, resnet, sknet, tridentnet
from holocron_tpu_torch.nn import PyConv2d

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "jax_module,port_module,block,num_blocks,planes,kwargs",
    [
        # ScaleConv2d at scale 4 (widths 4 and 8 a split): a projecting stride-1 first
        # block (no cascade, last split pooled at stride 1), a strided one, a plain one
        (jax_res2net, res2net, "Bottle2neck", [1, 2], [8, 16], {"width_per_group": 26, "block_args": {"scale": 4}}),
        # SKConv2d: two dilated paths, channel-major attention over them
        (jax_sknet, sknet, "SKBottleneck", [1, 1], [8, 16], {}),
        # TridentConv2d: the stem's channels repeated three times, one kernel a conv
        (jax_tridentnet, tridentnet, "Tridentneck", [1, 1], [8, 16], {"num_repeats": 3}),
        # PyConv2d of 3 levels (not a power of two: 4, 4, 8 channels) and of 2
        (jax_pyconv, pyconv_resnet, "PyBottleneck", [1, 1], [16, 16],
         {"stem_pool": False, "block_args": [{"num_levels": 3, "groups": (1, 4, 8)}, {"num_levels": 2, "groups": (1, 4)}]}),
        (jax_pyconv, pyconv_resnet, "PyHGBottleneck", [1, 1], [16, 32],
         {"stem_pool": False, "width_per_group": 16, "block_args": [{"num_levels": 2, "groups": (2, 4)},
                                                                    {"num_levels": 1, "groups": (4,)}]}),
    ],
    ids=["res2net", "sknet", "tridentnet", "pyconv", "pyconvhg"],
)
def test_family_matches_jax(jax_module, port_module, block, num_blocks, planes, kwargs):
    check_resnet_parity(getattr(jax_module, block), getattr(port_module, block), num_blocks, planes, kwargs)


@pytest.mark.parametrize("num_levels,groups", [(3, None), (4, (1, 2, 2, 4)), (1, (2,))])
def test_pyconv_level_plan_matches_jax(num_levels, groups):
    """The channel split and group schedule, the default one included (16 channels:
    4, 4, 8 over three levels)."""
    jax_conv = JaxPyConv2d(16, 3, num_levels, padding=1, groups=groups)
    assert list(PyConv2d.level_plan(16, 3, num_levels, 1, groups)) == list(jax_conv._level_plan())
    conv = PyConv2d(8, 16, 3, num_levels, 1, groups, device="cpu")
    assert conv(torch.zeros(1, 8, 5, 5)).shape == (1, 16, 5, 5)


CFG = ([1, 1], [16, 32])
# groups 4, 8 channels a group per 64 of width: the grouped 3x3 convs have 2 and 4
# input channels a group, the 1x1 convs 64, 8 and 16
KWARGS = {"block_args": {"groups": 4}, "width_per_group": 8}


@pytest.fixture(scope="module")
def resnext():
    """A small ResNeXt in both packages on the same weights, BN statistics adapted by
    one train-mode forward in each, a calibration batch and a held-out batch."""
    rng = np.random.default_rng(4)
    calib = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    held_out = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    module = jax_resnet.ResNet(jax_resnet.Bottleneck, *CFG, **KWARGS)
    jm = Model(module).init(calib.shape, key=jax.random.key(0))
    jm.load_variables(randomize_bn(jm.variables, rng))
    pm = resnet.ResNet(resnet.Bottleneck, *CFG, device="cpu", **KWARGS)
    pm.load_state_dict(convert.resnet_state_dict(jax.tree.map(np.asarray, jm.variables), pm))
    jm(calib, train=True)
    with torch.no_grad():
        pm.train()(nchw(calib))
    return jm, pm.eval(), calib, held_out


def _selected(jq, pq):
    """The kernels of the convs each package made int8, as HWIO bytes."""
    ours = {m.kernel_q.numpy().tobytes() for m in pq.modules() if isinstance(m, quant.QuantizedConv2d)}
    theirs = {np.asarray(q["kernel_q"]).tobytes() for q in jq.qparams.values()}
    return ours, theirs


@pytest.mark.parametrize("min_in_channels,expected", [(16, 4), (None, 3)], ids=["min16", "default64"])
def test_quantize_model_selects_the_convs_jax_selects(resnext, min_in_channels, expected):
    """By per-group input channels: the grouped 3x3 convs (2 and 4 a group) and the
    3-channel stem stay float in both packages; the 1x1 convs nested in the blocks' ``Sequential`` (paths such
    as ``features.4.0.conv.0``) and the shortcuts are replaced."""
    jm, pm, calib, _ = resnext
    jq = jquant.quantize_model(jm, calibration_batches=[calib], min_in_channels=min_in_channels)
    pq = quant.quantize_model(pm, calibration_batches=[nchw(calib)], min_in_channels=min_in_channels)
    ours, theirs = _selected(jq, pq)
    assert ours == theirs and len(ours) == expected
    modules = dict(pq.named_modules())
    assert isinstance(modules["model.features.4.0.conv.0"], quant.QuantizedConv2d)
    assert isinstance(modules["model.features.5.0.downsample.0"], quant.QuantizedConv2d)
    assert type(modules["model.features.0"]) is torch.nn.Conv2d
    assert type(modules["model.features.4.0.conv.3"]) is torch.nn.Conv2d


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
def test_int8_resnet_matches_jax(resnext, calibrated):
    """The port's QuantizedModel against JAX's on the same weights and calibration (or
    per-call scales): logits within atol 1e-3 and the same top-1; BN stays after each
    int8 conv, as the JAX package serves a ResNet."""
    jm, pm, calib, held_out = resnext
    batches = [calib] if calibrated else None
    jq = jquant.quantize_model(jm, calibration_batches=batches, min_in_channels=16)
    pq = quant.quantize_model(pm, calibration_batches=None if batches is None else [nchw(calib)], min_in_channels=16)
    for batch in (calib, held_out):
        expected = np.asarray(jq(batch))
        with torch.no_grad():
            out = pq(nchw(batch)).numpy()
        np.testing.assert_allclose(out, expected, atol=1e-3)
        np.testing.assert_array_equal(out.argmax(-1), expected.argmax(-1))


@pytest.fixture(scope="module")
def wide_resnext():
    """A small ResNeXt whose grouped 3x3 convs have 32 and 64 input channels a group
    (2 groups), prepared as ``resnext``. Narrower groups would not do: below 32
    channels a group and at a batch of 32 or less, the JAX package runs a grouped conv
    as a masked dense conv (a TPU workaround), which its int8 selection skips, while
    the port keeps torch's grouped conv."""
    rng = np.random.default_rng(5)
    calib = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    held_out = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    kwargs = {"block_args": {"groups": 2}, "width_per_group": 128}
    module = jax_resnet.ResNet(jax_resnet.Bottleneck, *CFG, **kwargs)
    jm = Model(module).init(calib.shape, key=jax.random.key(0))
    jm.load_variables(randomize_bn(jm.variables, rng))
    pm = resnet.ResNet(resnet.Bottleneck, *CFG, device="cpu", **kwargs)
    pm.load_state_dict(convert.resnet_state_dict(jax.tree.map(np.asarray, jm.variables), pm))
    jm(calib, train=True)
    with torch.no_grad():
        pm.train()(nchw(calib))
    return jm, pm.eval(), calib, held_out


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
def test_int8_grouped_resnext_matches_jax(wide_resnext, calibrated):
    """With ``min_in_channels=32`` the grouped 3x3 convs (2 groups of 32 and of 64
    input channels) are int8 in both packages, as ``feature_group_count`` convs: the
    same selection, and logits within atol 1e-3 with the same top-1."""
    jm, pm, calib, held_out = wide_resnext
    batches = [calib] if calibrated else None
    jq = jquant.quantize_model(jm, calibration_batches=batches, min_in_channels=32)
    pq = quant.quantize_model(pm, calibration_batches=None if batches is None else [nchw(calib)], min_in_channels=32)
    ours, theirs = _selected(jq, pq)
    layers = [m for m in pq.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert ours == theirs and len(ours) == len(layers)
    grouped = [m for m in layers if m.groups > 1]
    assert [(m.groups, m.kernel_q.shape[2]) for m in grouped] == [(2, 32), (2, 64)]
    assert all(m.kernel_packed is None for m in grouped)
    for batch in (calib, held_out):
        expected = np.asarray(jq(batch))
        with torch.no_grad():
            out = pq(nchw(batch)).numpy()
        np.testing.assert_allclose(out, expected, atol=1e-3)
        np.testing.assert_array_equal(out.argmax(-1), expected.argmax(-1))


def test_quantize_resnext101_32x8d_selects_its_grouped_convs():
    """Full width, the default ``min_in_channels=64``: the convs the JAX package's
    ``quantize_model`` selects (traced over an abstract init with ``jax.eval_shape``,
    no weights made), among them stage 4's three grouped 3x3 convs (32 groups of 64),
    which take the general route; the int8 form runs."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    pm = resnet.resnext101_32x8d(device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    pq = quant.quantize_model(pm)
    layers = {path.removeprefix("model."): m for path, m in pq.named_modules() if isinstance(m, quant.QuantizedConv2d)}
    module = jax_resnet.ResNet(jax_resnet.Bottleneck, [3, 4, 23, 3], [64, 128, 256, 512], block_args={"groups": 32},
                               width_per_group=8)
    x = jnp.zeros((1, 32, 32, 3))

    def jax_selection(variables):
        model = SimpleNamespace(module=module, variables=variables, default_cfg=None, _input_shape=x.shape)
        return jquant.quantize_model(model).qparams

    qparams = jax.eval_shape(jax_selection, jax.eval_shape(module.init, jax.random.key(0), x))
    theirs = sorted(tuple(q["kernel_q"].shape) for q in qparams.values())
    assert sorted(tuple(m.kernel_q.shape) for m in layers.values()) == theirs
    grouped = {path: m for path, m in layers.items() if m.groups > 1}
    assert sorted(grouped) == ["features.7.0.conv.3", "features.7.1.conv.3", "features.7.2.conv.3"]
    assert all(m.groups == 32 and tuple(m.kernel_q.shape) == (3, 3, 64, 2048) for m in grouped.values())
    assert all(conv_route(64, 2048, 32) == "general" and m.kernel_packed is None for m in grouped.values())
    with torch.no_grad():
        out = pq(torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
    assert out.shape == (1, 10) and bool(torch.isfinite(out).all())
