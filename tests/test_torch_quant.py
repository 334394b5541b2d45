"""Parity of the port's int8 deploy form with ``holocron_tpu.quant``, on the CPU.

A small RepVGG is adapted, reparametrized and quantized by the JAX package; the port
gets the same deploy weights through ``holocron_tpu_torch.convert`` and the same
calibration batch.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from holocron_tpu import quant as jquant
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu_torch import convert, quant
from holocron_tpu_torch.kernels.int8_conv import int8_conv, int8_conv_acc, int8_conv_plain
from holocron_tpu_torch.models import RepVGG

torch.set_num_threads(2)

CFG = ([1, 1], [8, 16], 1.0, 1.0)


def _jax_path(path: str) -> str:
    """``features.{s}.{j}.branches`` (port) -> ``features_{s}_{j}/rep_conv`` (JAX)."""
    _, s, j, _ = path.split(".")
    return f"features_{s}_{j}/rep_conv"


@pytest.fixture(scope="module")
def deployed():
    """The JAX deploy model after one BN-adapting train step, the port's copy of it,
    a calibration batch and a held-out batch."""
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    held_out = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = Model(JaxRepVGG(*CFG)).init(calib.shape, key=jax.random.key(0))
    jm(calib, train=True)
    jm.reparametrize()
    pm = RepVGG(*CFG, device="cpu").reparametrize()
    pm.load_state_dict(convert.repvgg_state_dict(jax.tree.map(np.asarray, jm.variables)))
    return jm, pm.eval(), calib, held_out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_quantize_conv_params_equal_jax(deployed):
    jm, pm, _, _ = deployed
    paths = [p for p, m in pm.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(paths) == 4
    ours = quant.quantize_conv_params(pm, paths)
    theirs = jquant.quantize_conv_params(jm.variables["params"], [_jax_path(p) for p in paths])
    for p in paths:
        np.testing.assert_array_equal(ours[p]["kernel_q"].numpy(), np.asarray(theirs[_jax_path(p)]["kernel_q"]))
        np.testing.assert_array_equal(ours[p]["w_scale"].numpy(), np.asarray(theirs[_jax_path(p)]["w_scale"]))


@pytest.mark.parametrize(
    "ksize,stride,padding,dilation,c",
    [(3, 1, 1, 1, 16), (3, 2, 1, 1, 16), (3, 1, 2, 2, 12), (1, 2, 0, 1, 8), (3, 1, 1, 1, 3)],
    ids=["3x3", "3x3-s2", "3x3-d2", "1x1-s2", "3x3-c3"],
)
def test_int8_accumulator_equals_lax_conv(ksize, stride, padding, dilation, c):
    """The int32 accumulator equals JAX's ``lax.conv_general_dilated`` with
    ``preferred_element_type=int32`` (quant.py:259-268), exactly."""
    rng = np.random.default_rng(2)
    x_q = rng.integers(-127, 128, size=(2, 9, 10, c), dtype=np.int8)
    w_q = rng.integers(-127, 128, size=(ksize, ksize, c, 24), dtype=np.int8)
    dn = lax.conv_dimension_numbers(x_q.shape, w_q.shape, ("NHWC", "HWIO", "NHWC"))
    expected = lax.conv_general_dilated(
        jnp.asarray(x_q), jnp.asarray(w_q), (stride, stride), ((padding, padding), (padding, padding)),
        rhs_dilation=(dilation, dilation), dimension_numbers=dn, preferred_element_type=jnp.int32,
    )
    acc = int8_conv_acc(torch.from_numpy(x_q), torch.from_numpy(w_q), stride, padding, dilation)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(expected))


def test_int8_conv_epilogue_and_guards():
    """Epilogue ``acc * (s_x * w_scale) + bias`` in float32, cast to the output dtype;
    a ``groups`` that the weights' shape does not fit (I * groups != C) and non-int8
    operands are refused."""
    rng = np.random.default_rng(3)
    x_q = torch.from_numpy(rng.integers(-127, 128, size=(1, 5, 5, 8), dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(3, 3, 8, 4), dtype=np.int8))
    s_x = torch.tensor(0.02)
    w_scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, 4).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=4).astype(np.float32))
    acc = int8_conv_acc(x_q, w_q, 1, 1).float()
    y = int8_conv(x_q, w_q, s_x, w_scale, bias, 1, 1)
    torch.testing.assert_close(y, acc * (s_x * w_scale) + bias, rtol=0, atol=0)
    y16 = int8_conv(x_q, w_q, s_x, w_scale, bias.to(torch.bfloat16), 1, 1, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    torch.testing.assert_close(y16, int8_conv_plain(x_q, w_q, s_x, w_scale, bias.to(torch.bfloat16), 1, 1,
                                                    out_dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        int8_conv(x_q, w_q, s_x, w_scale, groups=2)
    with pytest.raises(TypeError):
        int8_conv(x_q.float(), w_q, s_x, w_scale)


def test_calibration_scales_match_jax(deployed):
    jm, pm, calib, _ = deployed
    ours = quant.calibrate(pm, [_nchw(calib)])
    theirs = jquant.calibrate(jm.module, jm.variables, [calib])
    assert {_jax_path(p) for p in ours} == set(theirs)
    for p, v in ours.items():
        np.testing.assert_allclose(v, theirs[_jax_path(p)], rtol=1e-5)


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
def test_int8_model_logits_match_jax(deployed, calibrated):
    """Same calibration batch (or per-call scales): int8 logits within atol 1e-3 and
    the same top-1 as JAX's QuantizedModel; the same convs are int8 in both."""
    jm, pm, calib, held_out = deployed
    jq = jquant.quantize_model(jm, calibration_batches=[calib] if calibrated else None, min_in_channels=8)
    pq = quant.quantize_model(pm, calibration_batches=[_nchw(calib)] if calibrated else None, min_in_channels=8)
    quantized = [p for p, m in pq.named_modules() if isinstance(m, quant.QuantizedConv2d)]
    assert sorted(_jax_path(p.removeprefix("model.")) for p in quantized) == sorted(jq.qparams)
    for batch in (calib, held_out):
        expected = np.asarray(jq(batch))
        with torch.no_grad():
            out = pq(_nchw(batch)).numpy()
        np.testing.assert_allclose(out, expected, atol=1e-3)
        np.testing.assert_array_equal(out.argmax(-1), expected.argmax(-1))


def test_selection_follows_policy_and_gate():
    """repvgg_a0's policy sets min_in_channels=48; the agreement gate counts matching
    argmaxes."""
    assert quant.selection_policy("repvgg_a0") == {"min_in_channels": 48}
    assert quant.selection_policy("no_such_arch") is None
    m = RepVGG([1, 1], [48, 64], 1.0, 1.0, generator=torch.Generator().manual_seed(0),
               device="cpu").reparametrize().eval()
    qm = quant.quantize_model(m, arch="repvgg_a0")
    int8 = sorted(p for p, mod in qm.named_modules() if isinstance(mod, quant.QuantizedConv2d))
    # the 3-channel stem stays float; every conv with >= 48 input channels is int8
    assert int8 == ["model.features.0.1.branches", "model.features.1.0.branches", "model.features.1.1.branches"]
    strided_off = quant.quantize_model(m, arch="repvgg_a0", quantize_strided=False)
    assert isinstance(dict(strided_off.named_modules())["model.features.1.0.branches"], torch.nn.Conv2d)
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    res = quant.measure_agreement(m, m, [x])
    assert res == {"top1_agreement": 1.0, "max_prob_drift": 0.0}
    with pytest.raises(ValueError):
        quant.quantize_model(m, calibration_batches=iter(()))


def test_policy_copy_equals_the_jax_policy_file():
    """The port's copy of the per-arch fields it reads equals the JAX package's
    quant_policy.json field for field; an arch with none of them has no entry."""
    import json
    from pathlib import Path

    policy = json.loads((Path(__file__).resolve().parents[1] / "holocron_tpu" / "models" / "_data"
                         / "quant_policy.json").read_text())
    fields = ("min_in_channels", "quantize_strided", "quality_veto")
    expected = {arch: {k: e[k] for k in fields if k in e} for arch, e in policy.items()}
    assert quant.QUANT_POLICY == {arch: e for arch, e in expected.items() if e}


def _naturalistic(rng, batch: int, size: int) -> np.ndarray:
    """bench.py:58-69's batches from a numpy seed, NCHW float32: bilinear-upsampled noise
    plus a per-image colour cast, standardized per image."""
    coarse = torch.from_numpy(rng.normal(size=(batch, 3, size // 8, size // 8)).astype(np.float32))
    img = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    img = img + 0.5 * torch.from_numpy(rng.normal(size=(batch, 3, 1, 1)).astype(np.float32))
    mean, std = img.mean(dim=(1, 2, 3), keepdim=True), img.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return ((img - mean) / (std + 1e-6)).numpy()


def test_int8_gate_protocol_matches_jax_on_the_same_weights():
    """The int8 agreement gate (settled in ROADMAP Queue 3) run by each package as its
    entry point runs it, on the same weights (the port's, carried into JAX by
    convert_state_dict) and the same naturalistic batches: the port as chip_smoke.py
    (BN warm-up in float32, bf16 deploy form, calibration in float32), JAX as
    bench.py:115-157 (a bf16-compute model throughout). On this random-weight model
    both gates fail (the port reads 0.92, JAX 0.90: near-ties of the bf16 logits that
    either int8 form flips), and they read within 5 images in 100 of each other: a gate
    that fails in the port fails in JAX too, on the same weights."""
    from holocron_tpu.models._torch_convert import convert_state_dict

    cfg, size, batch = ([1, 1, 1], [16, 32, 64], 1.0, 1.0), 64, 50
    rng = np.random.default_rng(0)
    warm = [_naturalistic(rng, batch, size) for _ in range(2)]
    calib = _naturalistic(rng, batch, size)
    gate = [_naturalistic(rng, batch, size) for _ in range(2)]

    def adapted(state):
        m = RepVGG(*cfg, device="cpu")
        m.load_state_dict(state)
        with torch.no_grad():
            m.train()
            for x in warm:
                m(torch.from_numpy(x))
            return m.eval().reparametrize()

    # random weights send every image to one class; a head bias that centres the logits
    # of the warm-up batches (BN statistics do not see it) spreads them over the classes
    state = RepVGG(*cfg, generator=torch.Generator().manual_seed(0), device="cpu").state_dict()
    with torch.no_grad():
        state["head.bias"] = -torch.cat([adapted(state)(torch.from_numpy(x)) for x in warm]).mean(0)
    pm = adapted(state)
    state = {k: v.numpy() for k, v in state.items()}
    pm16 = copy.deepcopy(pm).to(torch.bfloat16)
    pq = quant.quantize_model(pm, calibration_batches=[torch.from_numpy(calib)], min_in_channels=16).to(torch.bfloat16)
    port_gate = [torch.from_numpy(x).to(torch.bfloat16) for x in gate]
    ours = quant.measure_agreement(pm16, pq, port_gate)

    jm = Model(JaxRepVGG(*cfg, dtype=jnp.bfloat16)).init((batch, size, size, 3), key=jax.random.key(0))
    jm.variables = convert_state_dict(jm, state)
    for x in warm:
        jm(jnp.asarray(x.transpose(0, 2, 3, 1)), train=True)
    jm.reparametrize()
    variables = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jm.variables)
    fwd = jax.jit(lambda a: jm.module.apply(variables, a, train=False))
    jq = jquant.quantize_model(jm, calibration_batches=[jnp.asarray(calib.transpose(0, 2, 3, 1))], min_in_channels=16)
    jq.variables = variables
    qfwd, qparams = jq.apply_fn(), jq.qparams
    jfwd = jax.jit(lambda a: qfwd(jq.variables, qparams, a))
    jax_gate = [jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16) for x in gate]
    theirs = jquant.measure_agreement(fwd, jfwd, jax_gate)

    assert (ours["top1_agreement"] >= 0.99) == (theirs["top1_agreement"] >= 0.99)  # bench.py:156's floor
    assert abs(ours["top1_agreement"] - theirs["top1_agreement"]) <= 0.05
