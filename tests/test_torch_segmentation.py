"""Parity of the PyTorch port's segmentation models with the JAX package, on the CPU in
float32: UNet (bilinear, with the transposed conv, and with valid padding), UNet+,
UNet++, UNet3+ and DynamicUNet over its four encoders; a train-mode forward with its
BN statistics and gradients; the full-width parameter counts; the key layout of
``unet_rexnet13`` through the JAX package's own converter; the segmentation int8 gate
and UNet3+'s int8 form; the upsampling rules.

The JAX weights are drawn from a numpy seed on the shapes ``jax.eval_shape`` gives
(fan-out He-normal kernels, random biases, BN parameters and statistics), so that one
program compiles a case; ``holocron_tpu_torch.convert.segmentation_state_dict`` carries
them across. Layouts are narrow and inputs 32 px (40 px where DynamicUNet's UBlocks
shrink odd skip sizes, 124 px for valid padding). The port takes NCHW, JAX NHWC.

Tolerances (float32): logits within 1e-4 of their largest magnitude plus 1e-4 relative;
BN running statistics within 1e-5 of each tensor's largest value; each gradient within
1e-4 of its tensor's largest magnitude plus 1e-3 relative (``test_torch_resnet.py``'s);
upsampling within 1e-6; the nearest shrink, the pixel shuffle and the agreement counts
exact; each int8 conv's output within 1e-5 of its largest magnitude on the same input.
"""

import importlib
import math

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _close, nchw

from holocron_tpu import quant as jquant
from holocron_tpu.models._torch_convert import convert_state_dict
from holocron_tpu.models.core import Model
from holocron_tpu_torch import convert, quant
from holocron_tpu_torch.models import segmentation

torch.set_num_threads(2)

# the packages' ``unet`` functions hide their ``unet`` modules
junet, jpp, j3p, jenc = (importlib.import_module(f"holocron_tpu.models.segmentation.{name}")
                         for name in ("unet", "unetpp", "unet3p", "encoders"))
punet = importlib.import_module("holocron_tpu_torch.models.segmentation.unet")

NUM_CLASSES = 5
L4 = (4, 8, 16, 32)
L5 = (4, 8, 16, 32, 64)


def random_variables(module, x: np.ndarray, rng: np.random.Generator):
    """Variables of the JAX ``module`` on ``x``'s shape, drawn from ``rng``: kernels
    He-normal over their fan-out (``kh * kw * O``), biases normal(0, 0.1), BN scales
    uniform(0.5, 1.5), means normal(0, 0.1), variances uniform(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.asarray(x)))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_out = math.prod(leaf.shape[:-2]) * leaf.shape[-1]
            return rng.normal(0, math.sqrt(2 / fan_out), leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load_port(variables, pm):
    """``pm`` with the JAX variables, every key of it set (torch's ``num_batches_tracked``
    counters too)."""
    sd = convert.segmentation_state_dict(variables, pm)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    return pm


CASES = {
    "unet": (lambda: junet.UNet(L4, num_classes=NUM_CLASSES),
             lambda: segmentation.UNet(L4, num_classes=NUM_CLASSES, device="cpu"), 32),
    "unet-transposed-conv": (
        lambda: junet.UNet(L4, num_classes=NUM_CLASSES, bilinear_upsampling=False),
        lambda: segmentation.UNet(L4, num_classes=NUM_CLASSES, bilinear_upsampling=False, device="cpu"), 32),
    # valid convs: the skips are cropped to the shrinking expansive maps, 124 -> 4 px
    "unet-valid-padding": (lambda: junet.UNet(L4, num_classes=NUM_CLASSES, same_padding=False),
                           lambda: segmentation.UNet(L4, num_classes=NUM_CLASSES, same_padding=False, device="cpu"),
                           124),
    "unetp": (lambda: jpp.UNetp(L4, num_classes=NUM_CLASSES),
              lambda: segmentation.UNetp(L4, num_classes=NUM_CLASSES, device="cpu"), 32),
    "unetpp": (lambda: jpp.UNetpp(L4, num_classes=NUM_CLASSES),
               lambda: segmentation.UNetpp(L4, num_classes=NUM_CLASSES, device="cpu"), 32),
    "unet3p": (lambda: j3p.UNet3p(L5, num_classes=NUM_CLASSES),
               lambda: segmentation.UNet3p(L5, num_classes=NUM_CLASSES, device="cpu"), 32),
    "dynamic-unet-backbone": (
        lambda: junet.DynamicUNet(junet.UNetBackbone(L4), num_classes=NUM_CLASSES),
        lambda: segmentation.DynamicUNet(segmentation.UNetBackbone(L4), num_classes=NUM_CLASSES, device="cpu"), 32),
    # 40 px: skips of 20, 10, 5, 3 and 2 px, so every UBlock shrinks an odd size or by one
    "dynamic-vgg11": (
        lambda: junet.DynamicUNet(junet.VGG11Features(), num_classes=NUM_CLASSES),
        lambda: segmentation.DynamicUNet(segmentation.VGG11Features(), num_classes=NUM_CLASSES, device="cpu"), 40),
    "dynamic-resnet34": (
        lambda: junet.DynamicUNet(jenc.ResNet34Features(), num_classes=NUM_CLASSES, final_upsampling=True),
        lambda: segmentation.DynamicUNet(segmentation.ResNet34Features(), num_classes=NUM_CLASSES,
                                         final_upsampling=True, device="cpu"), 40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_segmentation_matches_jax(case):
    """Eval logits of each family on the same weights (random BN statistics)."""
    make_jax, make_port, size = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    module = make_jax()
    variables = random_variables(module, x, rng)
    pm = load_port(variables, make_port()).eval()
    ref = jax.jit(module.apply)(variables, x)
    with torch.no_grad():
        out = pm(nchw(x)).numpy()
    assert out.shape == tuple(np.asarray(ref).transpose(0, 3, 1, 2).shape)
    _close(out.transpose(0, 2, 3, 1), ref, 1e-4, f"{case} logits", rtol=1e-4)


def test_unet_rexnet13_through_jax_converter():
    """The port's ``unet_rexnet13`` keys are original Holocron's: its ``state_dict``
    (BN statistics randomized) through the JAX package's ``_convert_dynamic_unet``
    gives the JAX DynamicUNet over ReXNet-1.3x the port's logits (40 px: its UBlocks
    shrink odd sizes), and ``segmentation_state_dict`` carries those variables back
    exactly."""
    rng = np.random.default_rng(1)
    pm = segmentation.unet_rexnet13(num_classes=NUM_CLASSES, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for m in pm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    pm.eval()
    module = junet.DynamicUNet(jenc.ReXNetFeatures(width_mult=1.3, out_blocks=(0, 2, 4, 10, 15)),
                               num_classes=NUM_CLASSES, final_upsampling=True, act_layer=jax.nn.silu)
    variables = convert_state_dict(Model(module), pm.state_dict())
    x = rng.normal(size=(2, 40, 40, 3)).astype(np.float32)
    ref = jax.jit(module.apply)(variables, x)
    with torch.no_grad():
        out = pm(nchw(x)).numpy()
    _close(out.transpose(0, 2, 3, 1), ref, 1e-4, "unet_rexnet13 logits", rtol=1e-4)
    back = convert.segmentation_state_dict(jax.tree.map(np.asarray, variables), pm)
    state = pm.state_dict()
    assert set(back) == set(state)
    for key, value in back.items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0, msg=key)


def test_train_forward_and_grads_match_jax():
    """UNet3+ in train mode: logits, the updated BN running statistics, and the gradient
    of ``sum(logits * w)`` for every parameter, against ``jax.grad``."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(2, 32, 32, NUM_CLASSES)).astype(np.float32)
    module = j3p.UNet3p(L5, num_classes=NUM_CLASSES)
    variables = random_variables(module, x, rng)
    pm = load_port(variables, segmentation.UNet3p(L5, num_classes=NUM_CLASSES, device="cpu"))

    def loss_fn(params):
        logits, updated = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                       mutable=["batch_stats"])
        return jnp.sum(logits * w), (logits, updated["batch_stats"])

    (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    pm.train()
    out = pm(nchw(x))
    (out * nchw(w)).sum().backward()
    _close(out.detach().numpy().transpose(0, 2, 3, 1), logits, 1e-4, "train-mode logits", rtol=1e-4)

    stats = jax.tree.map(np.asarray, stats)
    expected = convert.segmentation_state_dict({"params": variables["params"], "batch_stats": stats}, pm)
    state = pm.state_dict()
    stat_keys = [k for k in expected if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules()) > 0
    for key in stat_keys:
        _close(state[key].numpy(), expected[key].numpy(), 1e-5, key)
    expected_grads = convert.segmentation_state_dict(
        {"params": jax.tree.map(np.asarray, grads), "batch_stats": stats}, pm)
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), expected_grads[name].numpy(), 1e-4, f"grad {name}", rtol=1e-3)


@pytest.mark.parametrize(
    "arch,kwargs,expected",
    [
        # tests/test_models_segmentation.py:14-18 (10 classes) and :49 (unet_rexnet13,
        # 21); unet2 at the factory's default 21 classes
        ("unet", {"num_classes": 10}, 18107082),
        ("unetp", {"num_classes": 10}, 28283850),
        ("unetpp", {"num_classes": 10}, 29537226),
        ("unet3p", {"num_classes": 10}, 26927370),
        ("unet3p", {"num_classes": 21}, 26930901),
        ("unet2", {}, 19507221),
        ("unet_rexnet13", {}, 9342782),
    ],
)
def test_full_width_num_params(arch, kwargs, expected):
    """The factories at full width (construction only, no forward)."""
    model = getattr(segmentation, arch)(device="cpu", **kwargs)
    assert sum(p.numel() for p in model.parameters()) == expected


def test_dynamic_unet_probe_leaves_bn_statistics():
    """DynamicUNet reads its encoder's channels from an eval forward: the encoder's
    norms keep their statistics and it keeps its mode."""
    encoder = segmentation.ResNet34Features()
    encoder.train()
    stats = ("running_mean", "running_var", "num_batches_tracked")
    before = {k: v.clone() for k, v in encoder.state_dict().items() if k.endswith(stats)}
    segmentation.DynamicUNet(encoder, num_classes=NUM_CLASSES, device="cpu")
    assert encoder.training
    for key, value in before.items():
        assert torch.equal(encoder.state_dict()[key], value), key


def test_upsampling_rules_match_jax():
    """``upsample2d`` (half-pixel bilinear, at the 2, 4, 8 and 16x of UNet3+) against
    ``jax.image.resize``; UBlock's shrink (legacy nearest) against the JAX package's
    floor rule on odd sizes; the pixel shuffle's channel order."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    for factor in (2, 4, 8, 16):
        ref = jax.image.resize(x, (2, 5 * factor, 7 * factor, 3), "bilinear")
        got = punet.upsample2d(nchw(x), factor).numpy().transpose(0, 2, 3, 1)
        _close(got, ref, 1e-6, f"upsample x{factor}")
    up = rng.normal(size=(2, 6, 10, 3)).astype(np.float32)
    for h, w in ((5, 9), (3, 5), (2, 3), (1, 1)):
        rows = np.floor(np.arange(h) * (6 / h)).astype(np.int32)
        cols = np.floor(np.arange(w) * (10 / w)).astype(np.int32)
        got = torch.nn.functional.interpolate(nchw(up), size=(h, w), mode="nearest").numpy().transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got, up[:, rows][:, :, cols])
    feats = rng.normal(size=(2, 3, 4, 12)).astype(np.float32)
    np.testing.assert_array_equal(torch.nn.PixelShuffle(2)(nchw(feats)).numpy().transpose(0, 2, 3, 1),
                                  np.asarray(junet.pixel_shuffle(jnp.asarray(feats), 2)))


def _onehot_logits(mask, num_classes: int = 3) -> torch.Tensor:
    return torch.nn.functional.one_hot(torch.tensor(mask), num_classes).permute(2, 0, 1)[None].float() * 10.0


def test_measure_agreement_segmentation_closed_form():
    """``tests/test_quant.py:253-273`` on NCHW logits: 3 of 4 pixels agree; class 0 IoU
    1/2, class 1 2/3, class 2 absent; perfect agreement; NaN on no batch."""
    ref = _onehot_logits([[0, 1], [1, 1]])
    q = _onehot_logits([[0, 1], [0, 1]])
    out = quant.measure_agreement_segmentation(lambda _: ref, lambda _: q, [torch.zeros(1)])
    assert math.isclose(out["pixel_agreement"], 0.75)
    assert math.isclose(out["mean_mask_iou"], (0.5 + 2 / 3) / 2)
    perfect = quant.measure_agreement_segmentation(lambda _: ref, lambda _: ref, [torch.zeros(1)])
    assert perfect == {"pixel_agreement": 1.0, "mean_mask_iou": 1.0}
    none = quant.measure_agreement_segmentation(lambda _: ref, lambda _: q, [])
    assert math.isnan(none["pixel_agreement"]) and math.isnan(none["mean_mask_iou"])


def test_measure_agreement_segmentation_matches_jax():
    """Random logits over 3 batches (ties between near-equal classes included): the
    same pixel agreement and mean IoU as the JAX gate."""
    rng = np.random.default_rng(4)
    refs = [rng.normal(size=(2, 9, 11, 6)).astype(np.float32) for _ in range(3)]
    qs = [r + rng.normal(0, 0.5, r.shape).astype(np.float32) for r in refs]
    ref_iter, q_iter = iter(refs), iter(qs)
    expected = jquant.measure_agreement_segmentation(lambda _: jnp.asarray(next(ref_iter)),
                                                     lambda _: jnp.asarray(next(q_iter)), range(3))
    ref_iter, q_iter = iter(refs), iter(qs)
    got = quant.measure_agreement_segmentation(lambda _: nchw(next(ref_iter)), lambda _: nchw(next(q_iter)),
                                               range(3))
    assert got["pixel_agreement"] == expected["pixel_agreement"]
    assert math.isclose(got["mean_mask_iou"], expected["mean_mask_iou"], rel_tol=1e-12)


def test_int8_unet3p_matches_jax():
    """UNet3+'s selective-int8 form (every conv of 8 input channels or more, per-call
    activation scales) against the JAX package's on the same weights: the same convs
    selected (the biased ``FSAggreg`` convs among them, the classifier too), and each
    int8 conv, fed the input its JAX counterpart saw in the JAX int8 forward, within
    1e-5 of that layer's output (``test_torch_detection.py``'s method: whole forwards
    diverge by rounding flips)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    module = j3p.UNet3p(L5, num_classes=NUM_CLASSES)
    variables = random_variables(module, x, rng)
    pm = load_port(variables, segmentation.UNet3p(L5, num_classes=NUM_CLASSES, device="cpu")).eval()
    jq = jquant.quantize_model(Model(module, variables), min_in_channels=8, input_shape=x.shape)
    pq = quant.quantize_model(pm, min_in_channels=8)
    layers = [m for m in pq.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert len(layers) == len(jq.qparams)
    assert {m.kernel_q.numpy().tobytes() for m in layers} == {np.asarray(q["kernel_q"]).tobytes()
                                                              for q in jq.qparams.values()}
    assert any(m.bias is not None for m in layers) and any(m.kernel_q.shape[3] == NUM_CLASSES for m in layers)
    fwd = jq.apply_fn()

    paths = []  # filled while tracing

    def recorded(variables, qparams, inp):
        seen = []

        def record(next_fn, args, kwargs, context):
            out = next_fn(*args, **kwargs)
            if isinstance(context.module, flax_nn.Conv) and context.method_name == "__call__":
                paths.append("/".join(context.module.path))
                seen.append((args[0], out))
            return out

        with flax_nn.intercept_methods(record):
            fwd(variables, qparams, inp)
        return seen

    seen = [(path, *pair) for path, pair in zip(paths, jax.jit(recorded)(jq.variables, jq.qparams, jnp.asarray(x)))]
    order = []
    hooks = [m.register_forward_pre_hook(lambda mod, _args: order.append(mod)) for m in pq.modules()
             if isinstance(m, (quant.QuantizedConv2d, torch.nn.Conv2d))]
    try:
        with torch.no_grad():
            pq(nchw(x))
    finally:
        for h in hooks:
            h.remove()
    assert len(order) == len(seen)
    checked = 0
    with torch.no_grad():
        for mod, (path, inp, ref) in zip(order, seen):
            if not isinstance(mod, quant.QuantizedConv2d):
                continue
            out = mod(nchw(np.asarray(inp)))
            _close(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), 1e-5, f"int8 {path}")
            checked += 1
    assert checked == len(layers)
