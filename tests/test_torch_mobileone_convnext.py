"""Parity of the port's MobileOne and ConvNeXt with the JAX package, on the CPU in
float32.

The JAX package makes the weights (MobileOne's BN parameters and statistics, and
ConvNeXt's LayerScale, drawn from a numpy seed); ``holocron_tpu_torch.convert`` carries
them across and the JAX package's ``_convert_mobileone`` / ``_convert_convnext`` carry
the port's ``state_dict`` back, exactly.

Tolerances (float32): eval logits within 1e-5 of the logits' largest magnitude; the
reparametrized form within 1e-5 of the JAX package's reparametrized form at the same
scale; train-mode logits within 5e-4 of that scale (``test_torch_rexnet.py``'s bound: the last
stages' batch statistics come from 2 to 8 values a channel at these sizes, which
amplifies rounding); the port's reparametrization drift (train form against deploy form, eval) under
the JAX test's 1e-3 relative bound (``tests/test_models_classification.py:196-207``).
ConvNeXt's train-mode gradients within 1e-4 of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _close, nchw, randomize_bn

from holocron_tpu.models._torch_convert import convert_state_dict
from holocron_tpu.models.classification import convnext as jax_convnext
from holocron_tpu.models.classification import mobileone as jax_mobileone
from holocron_tpu.models.core import Model
from holocron_tpu_torch import convert, models, quant
from holocron_tpu_torch.models.classification import convnext, mobileone

torch.set_num_threads(2)

NUM_CLASSES = 10


def _assert_round_trip(module, variables, state_dict) -> None:
    back = convert_state_dict(Model(module), state_dict)
    if "batch_stats" not in variables:  # ConvNeXt: no BN
        assert back.pop("batch_stats") == {}
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _mobileone_pair(num_blocks, widths, k, size, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    module = jax_mobileone.MobileOne(num_blocks, widths, k, num_classes=NUM_CLASSES)
    variables = randomize_bn(jax.jit(module.init)(jax.random.key(seed), x), rng)
    pm = mobileone.MobileOne(num_blocks, widths, k, num_classes=NUM_CLASSES, device="cpu")
    pm.load_state_dict(convert.mobileone_state_dict(variables, pm))
    return x, module, variables, pm


MOBILEONES = {
    # identity branches in both block kinds, two 3x3 branches each, stride-2 first blocks
    "small-k2": ([1, 2, 1, 1], [0.125, 0.125, 0.125, 0.125], 2, 32),
    "mobileone_s1-64px": ([2, 8, 10, 1], [1.5, 1.5, 2.0, 2.5], 1, 64),
}
# train-mode logits are compared on the small model only: through mobileone_s1's 22
# blocks, batch statistics of 2 x 2 x 2 values a channel make them ill-conditioned
TRAIN_MODE = {"small-k2"}


@pytest.mark.parametrize("name", list(MOBILEONES))
def test_mobileone_matches_jax_in_both_forms(name):
    """The round trip of the train form; the eval forward within 1e-5; a train-mode
    forward (batch statistics) within 5e-4 (the small model); the reparametrized forms against each other
    within 1e-5, their weights too, and the port's drift under 1e-3 relative."""
    num_blocks, widths, k, size = MOBILEONES[name]
    x, module, variables, pm = _mobileone_pair(num_blocks, widths, k, size)
    _assert_round_trip(module, variables, pm.state_dict())

    ref = np.asarray(jax.jit(module.apply)(variables, x))
    pm.eval()
    with torch.no_grad():
        train_form = pm(nchw(x)).numpy()
    _close(train_form, ref, 1e-5, "train-form eval logits")

    if name in TRAIN_MODE:
        logits, _ = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
        trained = mobileone.MobileOne(num_blocks, widths, k, num_classes=NUM_CLASSES, device="cpu")
        trained.load_state_dict(pm.state_dict())
        with torch.no_grad():
            _close(trained.train()(nchw(x)).numpy(), np.asarray(logits), 5e-4, "train-mode logits")

    deploy_module, deploy_vars = module.reparametrize(variables)
    deploy_ref = np.asarray(jax.jit(deploy_module.apply)(deploy_vars, x))
    pm.reparametrize()
    with torch.no_grad():
        deployed = pm(nchw(x)).numpy()
    _close(deployed, deploy_ref, 1e-5, "deploy-form logits")
    drift = float(np.abs(deployed - train_form).max())
    assert drift <= 1e-3 * max(1.0, float(np.abs(train_form).max())), drift
    expected = convert.mobileone_state_dict(jax.tree.map(np.asarray, deploy_vars), pm)
    state = pm.state_dict()
    assert list(expected) == list(state)
    for key, value in expected.items():
        _close(state[key].numpy(), value.numpy(), 1e-5, key)
    with pytest.raises(AssertionError):
        pm.reparametrize()


def test_mobileone_reparametrize_folds_each_block_into_one_conv():
    """Every depthwise block a biased 3x3 depthwise conv (stride 2 where it was), every
    pointwise block a biased 1x1 conv, each the only module at its block's ``.0``."""
    pm = models.mobileone_s0(num_classes=NUM_CLASSES, device="cpu").reparametrize()
    depth = [m for m in pm.modules() if isinstance(m, mobileone.DepthConvBlock)]
    point = [m for m in pm.modules() if isinstance(m, mobileone.PointConvBlock)]
    assert len(depth) == len(point) == 22
    for block in depth:
        (conv,) = block
        assert conv.kernel_size == (3, 3) and conv.groups == conv.in_channels and conv.bias is not None
        assert conv.stride == (block.stride, block.stride)
    for block in point:
        (conv,) = block
        assert conv.kernel_size == (1, 1) and conv.groups == 1 and conv.bias is not None
    convs = [m for m in pm.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 44


def test_convnext_matches_jax_with_drawn_layer_scale():
    """``ConvNeXt([1, 1], [8, 16])`` at 32 px, every LayerScale drawn from a normal of
    std 0.1 (at its 1e-6 init the blocks would add nearly nothing): the round trip, the
    logits within 1e-5 and the gradient of ``sum(logits * w)`` for every parameter."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(2, NUM_CLASSES)).astype(np.float32)
    module = jax_convnext.ConvNeXt([1, 1], [8, 16], num_classes=NUM_CLASSES)
    variables = jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.key(0), x))
    for name, node in variables["params"].items():
        if "layer_scale" in node:
            node["layer_scale"]["weight"] = rng.normal(0, 0.1, node["layer_scale"]["weight"].shape).astype(np.float32)
        for norm in ("norm", "scale"):
            if norm == "norm" and norm in node:
                node[norm]["scale"] = rng.uniform(0.5, 1.5, node[norm]["scale"].shape).astype(np.float32)
    pm = convnext.ConvNeXt([1, 1], [8, 16], num_classes=NUM_CLASSES, device="cpu")
    pm.load_state_dict(convert.convnext_state_dict(variables, pm))
    _assert_round_trip(module, variables, pm.state_dict())

    def loss_fn(params):
        logits = module.apply({"params": params}, x, train=True)
        return jnp.sum(logits * w), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    out = pm.train()(nchw(x))
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), logits, 1e-5, "logits")
    expected = convert.convnext_state_dict({"params": jax.tree.map(np.asarray, grads)}, pm)
    scale = max(float(g.abs().max()) for g in expected.values())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=f"grad {name}")


def test_convnext_stochastic_depth_rates_follow_the_block_index():
    pm = convnext.ConvNeXt([2, 3], [8, 16], stochastic_depth_prob=0.4, device="cpu")
    rates = [m.stochastic_depth.p for m in pm.modules() if isinstance(m, convnext.Bottlenext)]
    np.testing.assert_allclose(rates, [0.4 * i / 4 for i in range(5)])


def test_stochastic_depth_keeps_whole_rows_scaled_by_survival():
    """``convnext.py:39-46``: in training each row is either zero or the input over the
    survival rate; in eval, or at p = 0, the input itself. Drawn from the generator
    given, so the same seed gives the same rows."""
    x = torch.rand(64, 3, 4, 4) + 0.5
    p = 0.3
    out = convnext.stochastic_depth(x, p, True, torch.Generator().manual_seed(0))
    again = convnext.stochastic_depth(x, p, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    kept = out.flatten(1).ne(0).all(dim=1)
    dropped = out.flatten(1).eq(0).all(dim=1)
    assert bool((kept | dropped).all()) and 0 < int(kept.sum()) < 64
    torch.testing.assert_close(out[kept], x[kept] / (1 - p), rtol=0, atol=0)
    assert convnext.stochastic_depth(x, p, False) is x
    assert convnext.stochastic_depth(x, 0.0, True) is x
    module = convnext.StochasticDepth(p)
    module.generator = torch.Generator().manual_seed(0)
    assert torch.equal(module.train()(x), out)


def _shape_variables(module, size, rng):
    """The JAX variables of ``module`` at full width drawn from ``rng`` by shape, with no
    initialization run (``jax.eval_shape``)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, size, size, 3)))
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("arch,count", [("mobileone_s1", 3_555_188), ("convnext_tiny", 27_827_818)])
def test_full_width_counts_and_round_trip(arch, count):
    """At 10 classes, the parameter count of the port's model and of the JAX package's;
    the JAX variables (drawn by shape) -> the port's ``state_dict`` -> the JAX package's
    converter, exactly."""
    jax_model = getattr(jax_models_classification(), arch)(num_classes=NUM_CLASSES)
    pm = getattr(models, arch)(num_classes=NUM_CLASSES, device="cpu")
    assert sum(p.numel() for p in pm.parameters()) == count
    variables = _shape_variables(jax_model.module, 64, np.random.default_rng(0))
    assert sum(v.size for v in jax.tree.leaves(variables["params"])) == count
    to_port = convert.mobileone_state_dict if arch.startswith("mobileone") else convert.convnext_state_dict
    sd = to_port(variables, pm)
    pm.load_state_dict(sd)
    _assert_round_trip(jax_model.module, variables, pm.state_dict())


def jax_models_classification():
    from holocron_tpu.models import classification

    return classification


@pytest.mark.parametrize("arch,int8,strided", [("mobileone_s1", 21, 0), ("convnext_tiny", 39, 3)])
def test_int8_selection_at_full_width(arch, int8, strided):
    """The int8 form selects the JAX policy's convs (no selection fields for these archs,
    so 64 input channels and strided convs alike): mobileone_s1's 21 1x1 convs of its
    deploy form (its depthwise convs have one channel a group), convnext_tiny's 36 1x1
    convs and its three 2x2 stride-2 downsamples, never its 3-channel stem."""
    assert quant.selection_policy(arch) is None
    pm = getattr(models, arch)(num_classes=NUM_CLASSES, device="cpu")
    if hasattr(pm, "reparametrize"):
        pm.eval().reparametrize()
    qm = quant.quantize_model(pm, arch=arch)
    layers = [m for m in qm.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert len(layers) == int8
    assert sum(m.stride != (1, 1) for m in layers) == strided
    assert all(m.kernel_q.shape[2] >= 64 and m.groups == 1 for m in layers)
