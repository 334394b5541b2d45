"""Parity of the PyTorch port's ResNet container and its shared layers with the JAX
package, on the CPU in float32.

The JAX package makes the weights (BN parameters and statistics randomized from a
numpy seed); ``holocron_tpu_torch.convert.resnet_state_dict`` carries them across and
``holocron_tpu.models._torch_convert.convert_state_dict`` carries the port's back.
Inputs come from numpy with a fixed seed; the port takes NCHW, JAX NHWC.
``test_torch_resnet_family.py`` holds the other blocks of the family with the same
harness.

Tolerances (float32): logits within 1e-4 of the logits' largest magnitude plus 1e-4
relative; BN running statistics within 1e-5 relative to each tensor's largest value;
each gradient within 1e-4 of its tensor's largest magnitude plus 1e-3 relative.
"""

import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu import models as jax_models
from holocron_tpu.models._torch_convert import convert_state_dict
from holocron_tpu.models.classification import resnet as jax_resnet
from holocron_tpu.models.core import Model
from holocron_tpu.models.layers import FrozenBatchNorm2d as JaxFrozenBatchNorm2d
from holocron_tpu.models.layers import avg_pool2d as jax_avg_pool2d
from holocron_tpu.models.layers import max_pool2d as jax_max_pool2d
from holocron_tpu.models.utils import ConvSequence as JaxConvSequence
from holocron_tpu.nn.modules.downsample import BlurPool2d as JaxBlurPool2d
from holocron_tpu_torch import convert, models
from holocron_tpu_torch.models.classification import resnet
from holocron_tpu_torch.models.layers import BatchNorm2d, FrozenBatchNorm2d, avg_pool2d, max_pool2d
from holocron_tpu_torch.models.utils import ConvSequence, conv_sequence
from holocron_tpu_torch.nn import BlurPool2d

torch.set_num_threads(2)

NUM_CLASSES = 10


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """No network: fetching a release URL fails as it does offline, into an empty cache."""
    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("HOLOCRON_CACHE_DIR", str(tmp_path))


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def randomize_bn(variables, rng):
    """Every BN's scale, bias, mean and variance drawn from ``rng``, so that eval
    forwards and gradients go through non-trivial statistics."""

    def visit(params, stats):
        for name, node in params.items():
            if not isinstance(node, dict):
                continue
            if "scale" in node and not isinstance(node["scale"], dict):
                c = node["scale"].shape[0]
                params[name] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                                "bias": rng.normal(0, 0.1, c).astype(np.float32)}
                stats[name] = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                               "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            elif name in stats:
                visit(node, stats[name])

    variables = jax.tree.map(np.asarray, variables)
    visit(variables["params"], variables["batch_stats"])
    return variables


def _close(got, ref, rel: float, what: str, rtol: float = 0.0) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rel * max(float(np.abs(ref).max()), 1e-12), err_msg=what)


def check_resnet_parity(jax_block, port_block, num_blocks, planes, kwargs, seed: int = 0, size: int = 32) -> None:
    """One JAX ``ResNet`` and the port's on the same weights and input:

    - the state dict round trip: JAX variables -> port -> JAX, exactly;
    - a train-mode forward: logits, every updated BN running statistic, and the
      gradient of ``sum(logits * w)`` for every parameter;
    - the eval forward after it.
    """
    rng = np.random.default_rng(seed)
    # batch 4: SKNet's attention normalizes 1 x 1 maps, whose batch statistics come from
    # the batch alone
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(4, NUM_CLASSES)).astype(np.float32)
    module = jax_resnet.ResNet(jax_block, num_blocks, planes, num_classes=NUM_CLASSES, **kwargs)
    variables = randomize_bn(jax.jit(module.init)(jax.random.key(seed), x), rng)
    pm = resnet.ResNet(port_block, num_blocks, planes, num_classes=NUM_CLASSES, device="cpu", **kwargs)
    pm.load_state_dict(convert.resnet_state_dict(variables, pm))

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
    _close(out.detach().numpy(), logits, 1e-4, "train-mode logits", rtol=1e-4)

    stats = jax.tree.map(np.asarray, stats)
    expected_stats = convert.resnet_state_dict({"params": variables["params"], "batch_stats": stats}, pm)
    state = pm.state_dict()
    stat_keys = [k for k in expected_stats if k.endswith(("running_mean", "running_var"))]
    assert stat_keys
    for key in stat_keys:
        _close(state[key].numpy(), expected_stats[key].numpy(), 1e-5, key)

    expected_grads = convert.resnet_state_dict({"params": jax.tree.map(np.asarray, grads), "batch_stats": stats}, pm)
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), expected_grads[name].numpy(), 1e-4, f"grad {name}", rtol=1e-3)

    pm.eval()
    with torch.no_grad():
        out = pm(nchw(x)).numpy()
    ref = jax.jit(lambda v: module.apply(v, x))({"params": variables["params"], "batch_stats": stats})
    _close(out, ref, 1e-4, "eval logits", rtol=1e-4)


@pytest.mark.parametrize(
    "block,num_blocks,planes,kwargs",
    [
        ("BasicBlock", [1, 1], [8, 16], {}),
        # ResNeXt: grouped 3x3 convs (8 and 16 channels in 4 groups)
        ("Bottleneck", [1, 1], [8, 16], {"block_args": {"groups": 4}, "width_per_group": 8}),
        # ResNet-D: the deep stem and the average-pool shortcut, a ceil_mode pool on 9 x 9 maps
        ("Bottleneck", [1, 2], [8, 16], {"deep_stem": True, "avg_downsample": True}),
    ],
    ids=["basic", "resnext", "deep-stem-avg-downsample"],
)
def test_resnet_matches_jax(block, num_blocks, planes, kwargs):
    check_resnet_parity(getattr(jax_resnet, block), getattr(resnet, block), num_blocks, planes, kwargs,
                        size=36 if kwargs.get("deep_stem") else 32)


@pytest.mark.parametrize(
    "kernel_size,stride,padding,ceil_mode,count_include_pad",
    [(2, 2, 0, True, False), (3, 2, 1, False, True), (3, 1, 1, False, True), (3, 2, 1, True, True),
     (3, 2, 0, True, False), (3, 2, 1, False, False)],
    ids=["resnet-d", "res2net-s2", "res2net-s1", "ceil-pad-counted", "ceil-no-pad", "pad-not-counted"],
)
def test_pools_match_jax(kernel_size, stride, padding, ceil_mode, count_include_pad):
    """``avg_pool2d`` (and ``max_pool2d`` at the same window) against the JAX
    functions on odd sizes (7 x 9), where ``ceil_mode`` adds a window past the input."""
    x = np.random.default_rng(1).normal(size=(2, 7, 9, 5)).astype(np.float32)
    got = avg_pool2d(nchw(x), kernel_size, stride, padding, ceil_mode, count_include_pad)
    ref = jax_avg_pool2d(jnp.asarray(x), kernel_size, stride, padding, ceil_mode, count_include_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)
    if not ceil_mode:
        got = max_pool2d(nchw(x), kernel_size, stride, padding)
        ref = jax_max_pool2d(jnp.asarray(x), kernel_size, stride, padding)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))


def test_frozen_batchnorm_matches_jax():
    """Buffers, never parameters; the JAX module's output in float32 and bf16, and the
    converter's mapping of its ``batch_stats``."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 5, 6)).astype(np.float32)
    stats = {"scale": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(size=6), "mean": rng.normal(size=6),
             "var": rng.uniform(0.5, 1.5, 6)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    ref = np.asarray(JaxFrozenBatchNorm2d().apply({"batch_stats": stats}, jnp.asarray(x)))
    fbn = FrozenBatchNorm2d(6)
    assert not list(fbn.parameters())
    sd = {}
    convert._norm_at(sd, "fbn", {"params": {}, "batch_stats": {"fbn": stats}}, "fbn")
    fbn.load_state_dict({k.removeprefix("fbn."): v for k, v in sd.items()})
    np.testing.assert_allclose(fbn(nchw(x)).numpy(), ref.transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)
    out16 = fbn(nchw(x).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), ref.transpose(0, 3, 1, 2), rtol=2**-7, atol=2**-7)


def test_blurpool_and_conv_sequence_match_jax():
    """``BlurPool2d`` alone, and ``ConvSequence`` with ``blurpool``: conv (stride moved
    to the pool, no bias under the norm) at offset 0, norm at 1, act at 2, pool at 3."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 10, 4)).astype(np.float32)
    got = BlurPool2d(4, 3, 2)(nchw(x))
    ref = JaxBlurPool2d(3, 2).apply({}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)
    assert not BlurPool2d(4).state_dict()

    module = JaxConvSequence(8, kernel_size=3, stride=2, padding=1, act_layer=jax.nn.relu, norm_layer=True,
                             blurpool=True)
    init = module.init(jax.random.key(0), x)
    variables = randomize_bn({"params": {"seq": init["params"]}, "batch_stats": {"seq": init["batch_stats"]}}, rng)
    seq = ConvSequence(4, 8, act_layer=torch.nn.ReLU(), norm_layer=BatchNorm2d, kernel_size=3, stride=2, padding=1,
                       blurpool=True)
    assert [type(m) for m in seq] == [torch.nn.Conv2d, BatchNorm2d, torch.nn.ReLU, BlurPool2d]
    assert seq[0].stride == (1, 1) and seq[0].bias is None
    sd = {}
    convert._conv_at(sd, "0", variables["params"]["seq"]["conv"])
    convert._norm_at(sd, "1", variables, "seq/bn")
    seq.load_state_dict(sd)
    with torch.no_grad():
        got = seq.eval()(nchw(x))
    ref = module.apply({"params": variables["params"]["seq"], "batch_stats": variables["batch_stats"]["seq"]},
                       jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    # drop and attention follow, in that order; a norm switches the bias off unless asked
    layers = conv_sequence(4, 8, None, BatchNorm2d, lambda: torch.nn.Dropout(0.1), None, None,
                           lambda c: torch.nn.Identity(), kernel_size=1, bias=True)
    assert [type(m) for m in layers] == [torch.nn.Conv2d, BatchNorm2d, torch.nn.Identity, torch.nn.Dropout]
    assert layers[0].bias is not None


# tests/test_models_classification.py:139-152, from the reference's checkpoint metadata
PARAM_COUNTS = {
    "resnet18": 11181642,
    "resnet50": 23528522,
    "resnet50d": 23547754,
    "resnext50_32x4d": 23000394,
    "res2net50_26w_4s": 23670610,
    "sknet50": 35224394,
    "tridentnet50": 45826634,
    "pyconv_resnet50": 22819210,
    "pyconvhg_resnet50": 23206218,
}


@pytest.mark.parametrize(
    "arch", [*PARAM_COUNTS, "resnet34", "resnet101", "resnet152", "resnext101_32x8d", "sknet101", "sknet152"]
)
def test_full_width_parameter_count(arch, offline):
    """Every constructor builds the JAX package's parameter count: the nine that the JAX
    tests hold against the reference's counts, held against the same constants; the
    others against the JAX constructor's, from ``jax.eval_shape`` of its init (traced,
    never compiled). ``pretrained=True`` raises."""
    pm = getattr(models, arch)(generator=torch.Generator().manual_seed(0), device="cpu")
    count = sum(p.numel() for p in pm.parameters())
    if arch in PARAM_COUNTS:
        assert count == PARAM_COUNTS[arch]
    else:
        module = getattr(jax_models, arch)().module
        shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
        assert count == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert pm.head.out_features == 10 and "head.weight" in pm.state_dict()
    assert not getattr(models, arch)(pretrained=True, device="meta").pretrained_loaded


def test_resnet50_layout_and_init():
    """resnet50's keys are original Holocron's (stem at 0-2, max pool at 3, stages at
    4-7); the seed fixes the weights; convs are fan-out He-normal, the head has a zero
    bias, and ``zero_init_residual`` zeroes each block's last norm."""
    pm = models.resnet50(generator=torch.Generator().manual_seed(0), device="cpu")
    keys = pm.state_dict().keys()
    assert {"features.0.weight", "features.1.running_var", "features.4.0.downsample.0.weight",
            "features.4.0.conv.7.weight", "features.7.2.conv.6.weight"} <= set(keys)
    again = models.resnet50(generator=torch.Generator().manual_seed(0), device="cpu").state_dict()
    assert all(torch.equal(v, again[k]) for k, v in pm.state_dict().items())
    w = pm.features[4][0].conv[3].weight  # 3x3, 64 -> 64: std = sqrt(2 / (64 * 9))
    assert abs(float(w.detach().std()) / (2 / (64 * 9)) ** 0.5 - 1) < 0.02
    assert not pm.head.bias.any()
    zero = models.resnet18(zero_init_residual=True, device="cpu")
    assert not zero.features[4][0].conv[4].weight.any() and zero.features[4][0].conv[1].weight.all()
    d = models.resnet50d(device="cpu")
    assert type(d.features[11][0].downsample[0]).__name__ == "AvgPool2d"  # stem 0-8, pool 9, stages 10-13
