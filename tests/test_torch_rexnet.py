"""Parity of the PyTorch port's ReXNet with the JAX package, on the CPU in float32, and
of its int8 form with the JAX package's ``QuantizedModel``.

The JAX package makes the weights (BN parameters and statistics randomized from a
numpy seed); ``holocron_tpu_torch.convert.rexnet_state_dict`` carries them across and
``holocron_tpu.models._torch_convert.convert_state_dict`` (``_convert_rexnet``) carries
the port's back. ``dropout_ratio=0`` so that both packages compute the same function in
train mode (their dropout draws differ by design).

Tolerances (float32): eval logits within 1e-4 of the logits' largest magnitude plus
1e-4 relative, and each eval-mode gradient within 1e-4 of its tensor's largest
magnitude plus 1e-3 relative (both ``test_torch_resnet.py``'s). Train-mode logits
within 5e-4 of their largest magnitude plus 1e-4 relative: the JAX package's own
float32 train-mode logits lie 1.4e-4 of that scale from the float64 ones at
width 1.0 (the port's 1.3e-5; float64: the port's model in float64, the reference of
every such measurement here). BN running statistics within 5e-4
relative to each tensor's largest value, where the ResNets hold 1e-5: the SE norms'
batch variance comes from 4 values a channel (N x C x 1 x 1 maps) at the end of ten or
more blocks, which amplifies rounding, and the JAX package's own float32 statistics
lie up to 1.4e-4 of that scale from the float64 ones (the port's 8e-6). Train-mode gradients
within 5e-3 of the largest gradient of the model: batch statistics over 4 values a
channel make them ill-conditioned, and the JAX package's own float32 gradients lie
1.0e-3 to 1.3e-3 of that scale from the same model's float64 gradients (the port's
float32 ones 0.8e-4 to 2.7e-4), measured on both configurations tested here; the
gradients of the biases whose shift the next train-mode norm removes are zero in
exact arithmetic and rounding noise in both packages, so a per-tensor scale does not
apply. The int8 forms: logits within atol 1e-3 and the same top-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _close, nchw, randomize_bn

from holocron_tpu import models as jax_models
from holocron_tpu import quant as jquant
from holocron_tpu.models._torch_convert import convert_state_dict
from holocron_tpu.models.classification import rexnet as jax_rexnet
from holocron_tpu.models.core import Model
from holocron_tpu_torch import convert, models, quant
from holocron_tpu_torch.kernels.int8_conv import conv_route
from holocron_tpu_torch.models.classification import rexnet

torch.set_num_threads(2)

NUM_CLASSES = 10
ARCHS = ("rexnet1_0x", "rexnet1_3x", "rexnet1_5x", "rexnet2_0x", "rexnet2_2x")


def _pair(width_mult: float, depth_mult: float, seed: int, x: np.ndarray):
    """A JAX ReXNet with randomized BN and the port's copy of it."""
    rng = np.random.default_rng(seed)
    module = jax_rexnet.ReXNet(width_mult, depth_mult, num_classes=NUM_CLASSES, dropout_ratio=0.0)
    variables = randomize_bn(jax.jit(module.init)(jax.random.key(seed), x), rng)
    pm = rexnet.ReXNet(width_mult, depth_mult, num_classes=NUM_CLASSES, dropout_ratio=0.0, device="cpu")
    pm.load_state_dict(convert.rexnet_state_dict(variables, pm))
    return module, variables, pm


@pytest.mark.parametrize("width_mult,depth_mult", [(0.5, 0.5), (1.0, 0.34)], ids=["w0.5-d0.5", "w1.0-d0.34"])
def test_rexnet_matches_jax(width_mult, depth_mult):
    """The state dict round trip (JAX -> port -> JAX, exactly); a train-mode forward:
    logits, every updated BN statistic (the SE norms' on N x C x 1 x 1 maps among them)
    and the gradient of ``sum(logits * w)`` for every parameter; the eval forward and
    its gradients."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(4, NUM_CLASSES)).astype(np.float32)
    module, variables, pm = _pair(width_mult, depth_mult, 0, x)

    back = convert_state_dict(Model(module), pm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)

    def loss_fn(params):
        logits, updated = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                       mutable=["batch_stats"])
        return jnp.sum(logits * w), (logits, updated["batch_stats"])

    (_, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    pm.train()
    out = pm(nchw(x))
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), logits, 5e-4, "train-mode logits", rtol=1e-4)

    stats = jax.tree.map(np.asarray, stats)
    expected_stats = convert.rexnet_state_dict({"params": variables["params"], "batch_stats": stats}, pm)
    state = pm.state_dict()
    stat_keys = [k for k in expected_stats if k.endswith(("running_mean", "running_var"))]
    assert any(".conv.1." in k for k in stat_keys)  # an SE norm
    for key in stat_keys:
        _close(state[key].numpy(), expected_stats[key].numpy(), 5e-4, key)

    expected_grads = convert.rexnet_state_dict({"params": jax.tree.map(np.asarray, grads), "batch_stats": stats}, pm)
    scale = max(float(g.abs().max()) for g in expected_grads.values())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected_grads[name].numpy(), rtol=0, atol=5e-3 * scale,
                                   err_msg=f"train-mode grad {name}")

    def eval_loss(params):
        logits = module.apply({"params": params, "batch_stats": stats}, x)
        return jnp.sum(logits * w), logits

    (_, ref), grads = jax.jit(jax.value_and_grad(eval_loss, has_aux=True))(variables["params"])
    pm.eval()
    pm.zero_grad()
    out = pm(nchw(x))
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), ref, 1e-4, "eval logits", rtol=1e-4)
    expected_grads = convert.rexnet_state_dict({"params": jax.tree.map(np.asarray, grads), "batch_stats": stats}, pm)
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), expected_grads[name].numpy(), 1e-4, f"eval grad {name}", rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_rexnet_param_counts_match_jax(arch):
    """Full-width parameter counts at the JAX package's 1000 classes: rexnet1_0x's
    4,796,186 (its checkpoint's count), the others against ``jax.eval_shape``."""
    pm = getattr(models, arch)(device="cpu")
    ours = sum(p.numel() for p in pm.parameters())
    jm = getattr(jax_models, arch)()
    shapes = jax.eval_shape(jm.module.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    assert ours == sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes["params"]))
    if arch == "rexnet1_0x":
        assert ours == 4796186 == rexnet.ReXNet1_0x_Checkpoint.DEFAULT.value.meta.num_params
    with pytest.raises(NotImplementedError):
        getattr(models, arch)(pretrained=True, device="cpu")


def test_rexnet_partial_residual():
    """As the JAX package's test: at stride 1 with growing channels and zero weights, the
    block's output is the input on the first ``in_channels`` channels and zero beyond,
    in the port and in JAX, on the same input."""
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 8)).astype(np.float32)
    block = rexnet.ReXBlock(8, 12, t=6, stride=1, use_se=False).eval()
    assert block.use_shortcut
    with torch.no_grad():
        for p in block.parameters():
            p.zero_()
        out = block(nchw(x)).numpy()
    np.testing.assert_allclose(out[:, :8], nchw(x).numpy(), atol=1e-6)
    np.testing.assert_allclose(out[:, 8:], 0.0, atol=1e-6)

    jblock = jax_rexnet.ReXBlock(channels=12, t=6, stride=1, use_se=False)
    variables = jblock.init(jax.random.key(1), x, train=False)
    zeroed = jax.tree.map(jnp.zeros_like, variables["params"])
    ref = jblock.apply({"params": zeroed, "batch_stats": variables["batch_stats"]}, x, train=False)
    np.testing.assert_allclose(out, np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-6)
    # a strided block and a narrowing one have no shortcut
    assert not rexnet.ReXBlock(8, 12, t=6, stride=2).use_shortcut
    assert not rexnet.ReXBlock(12, 8, t=6, stride=1).use_shortcut


def test_quantize_model_selects_the_convs_jax_selects_on_rexnet1_0x():
    """Full width, the default ``min_in_channels=64`` (rexnet has no policy entry): the
    same convs as the JAX package's ``quantize_model``, compared by their int8 kernels
    on the same weights; depthwise convs stay float. Every one takes the wgmma route,
    the odd and byte-wise widths too (the padded channel pitch and the masked
    epilogue)."""
    assert quant.selection_policy("rexnet1_0x") is None
    x = np.zeros((1, 32, 32, 3), np.float32)
    jm = Model(jax_rexnet.ReXNet(1, 1)).init(x.shape, key=jax.random.key(0))
    pm = rexnet.rexnet1_0x(device="cpu")
    pm.load_state_dict(convert.rexnet_state_dict(jax.tree.map(np.asarray, jm.variables), pm))
    jq = jquant.quantize_model(jm)
    pq = quant.quantize_model(pm.eval())
    layers = [m for m in pq.modules() if isinstance(m, quant.QuantizedConv2d)]
    ours = {m.kernel_q.numpy().tobytes() for m in layers}
    theirs = {np.asarray(q["kernel_q"]).tobytes() for q in jq.qparams.values()}
    assert ours == theirs and len(ours) == len(layers) == len(jq.qparams)
    assert all(m.groups == 1 for m in layers)
    routes = [conv_route(m.kernel_q.shape[2], m.kernel_q.shape[3]) for m in layers]
    assert routes.count("wgmma") == len(layers) == 44
    assert all(m.kernel_packed is not None for m in layers)
    depthwise = [m for m in pq.modules() if type(m) is torch.nn.Conv2d and m.groups > 1]
    assert depthwise and all(m.groups == m.in_channels for m in depthwise)


@pytest.fixture(scope="module")
def small_rexnet():
    """A small ReXNet in both packages on the same weights, BN statistics adapted by
    one train-mode forward in each, a calibration batch and a held-out batch."""
    rng = np.random.default_rng(4)
    calib = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    held_out = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    module = jax_rexnet.ReXNet(0.5, 0.5, num_classes=NUM_CLASSES, dropout_ratio=0.0)
    jm = Model(module).init(calib.shape, key=jax.random.key(0))
    jm.load_variables(randomize_bn(jm.variables, rng))
    pm = rexnet.ReXNet(0.5, 0.5, num_classes=NUM_CLASSES, dropout_ratio=0.0, device="cpu")
    pm.load_state_dict(convert.rexnet_state_dict(jax.tree.map(np.asarray, jm.variables), pm))
    jm(calib, train=True)
    with torch.no_grad():
        pm.train()(nchw(calib))
    return jm, pm.eval(), calib, held_out


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "dynamic"])
def test_int8_rexnet_matches_jax(small_rexnet, calibrated):
    """With ``min_in_channels=16``: odd output widths (the SE squeezes, the
    projections), the SE convs' 1 x 1 inputs and byte-wise input widths are int8 in
    both packages; the logits agree within atol 1e-3 with the same top-1."""
    jm, pm, calib, held_out = small_rexnet
    batches = [calib] if calibrated else None
    jq = jquant.quantize_model(jm, calibration_batches=batches, min_in_channels=16)
    pq = quant.quantize_model(pm, calibration_batches=None if batches is None else [nchw(calib)], min_in_channels=16)
    layers = [m for m in pq.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert len(layers) == len(jq.qparams)
    assert any(m.kernel_q.shape[3] % 2 for m in layers) and any(m.kernel_q.shape[2] % 16 for m in layers)
    for batch in (calib, held_out):
        expected = np.asarray(jq(batch))
        with torch.no_grad():
            out = pq(nchw(batch)).numpy()
        np.testing.assert_allclose(out, expected, atol=1e-3)
        np.testing.assert_array_equal(out.argmax(-1), expected.argmax(-1))
