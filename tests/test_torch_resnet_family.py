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
    3-channel stem stay float in both packages, and never reach the port's refusal of
    grouped int8 convs; the 1x1 convs nested in the blocks' ``Sequential`` (paths such
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
