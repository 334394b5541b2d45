"""Parity of the PyTorch port's darknets (v1 to v4) with the JAX package, on the CPU in
float32.

The JAX package makes the weights (BN parameters and statistics randomized from a numpy
seed); ``holocron_tpu_torch.convert.darknet_state_dict`` carries them across and
``holocron_tpu.models._torch_convert.convert_state_dict`` (``_convert_darknetv1`` to
``v4``) carries the port's back, exactly. One JAX model a version, narrow and shallow,
built once for the module (the JAX side compiles slowly on the CPU), at 32 px.

Tolerances (float32): logits and each body output within 1e-4 of its largest magnitude
plus 1e-4 relative (``test_torch_resnet.py``'s).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_resnet import _close, nchw, randomize_bn

from holocron_tpu.models._torch_convert import convert_state_dict
from holocron_tpu.models.classification import darknet as jdark1
from holocron_tpu.models.classification import darknetv2 as jdark2
from holocron_tpu.models.classification import darknetv3 as jdark3
from holocron_tpu.models.classification import darknetv4 as jdark4
from holocron_tpu.models.core import Model
from holocron_tpu.nn.modules.dropblock import DropBlock2d as JaxDropBlock2d
from holocron_tpu_torch import convert, models
from holocron_tpu_torch.models.classification import darknet, darknetv2, darknetv3, darknetv4
from holocron_tpu_torch.nn import DropBlock2d

torch.set_num_threads(2)

NUM_CLASSES = 5

# version: (JAX module, port module), narrow layouts; v4 twice, the mish variant's
# DropBlock shifting each conv block's offsets by one (_torch_convert.py:291-295)
CASES = {
    "v1": (lambda: jdark1.DarknetV1([[16], [16, 32]], num_classes=NUM_CLASSES),
           lambda: darknet.DarknetV1([[16], [16, 32]], num_classes=NUM_CLASSES, device="cpu")),
    "v2": (lambda: jdark2.DarknetV2([(8, 0), (16, 1), (32, 1)], num_classes=NUM_CLASSES),
           lambda: darknetv2.DarknetV2([(8, 0), (16, 1), (32, 1)], num_classes=NUM_CLASSES, device="cpu")),
    "v3": (lambda: jdark3.DarknetV3([(8, 1), (16, 2), (32, 1)], num_classes=NUM_CLASSES),
           lambda: darknetv3.DarknetV3([(8, 1), (16, 2), (32, 1)], num_classes=NUM_CLASSES, device="cpu")),
    "v4": (lambda: jdark4.DarknetV4([(8, 1), (16, 2), (32, 1)], num_classes=NUM_CLASSES),
           lambda: darknetv4.DarknetV4([(8, 1), (16, 2), (32, 1)], num_classes=NUM_CLASSES, device="cpu")),
    "v4_mish": (lambda: jdark4.DarknetV4([(8, 1), (16, 2), (32, 1)], num_classes=NUM_CLASSES, act_layer=jax.nn.mish,
                                         drop_layer=JaxDropBlock2d),
                lambda: darknetv4.DarknetV4([(8, 1), (16, 2), (32, 1)], num_classes=NUM_CLASSES,
                                            act_layer=torch.nn.Mish(), drop_layer=DropBlock2d, device="cpu")),
}


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request, x):
    """A JAX darknet with randomized BN (v1 has none) and the port's copy of it."""
    make_jax, make_port = CASES[request.param]
    module = make_jax()
    rng = np.random.default_rng(0)
    variables = jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.key(0), x))
    if "batch_stats" in variables:
        variables = randomize_bn(variables, rng)
    pm = make_port().eval()
    pm.load_state_dict(convert.darknet_state_dict(variables, pm))
    return request.param, module, variables, pm


def test_darknet_matches_jax(pair, x):
    """The state dict round trip (JAX -> port -> JAX, exactly) and the eval logits. (v1 has
    no norm: the JAX converter returns empty ``batch_stats`` for it.)"""
    _, module, variables, pm = pair
    back = convert_state_dict(Model(module), pm.state_dict())
    if "batch_stats" not in variables:
        assert back.pop("batch_stats") == {}
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref = jax.jit(module.apply)(variables, x)
    with torch.no_grad():
        out = pm(nchw(x)).numpy()
    assert out.shape == (2, NUM_CLASSES)
    _close(out, ref, 1e-4, "eval logits", rtol=1e-4)


def test_darknet_body_outputs_match_jax(pair, x):
    """Each body's multi-scale form on the classifier's weights: v2's passthrough pair,
    v3's and v4's last three stages, v1's single output."""
    version, _, variables, pm = pair
    body = pm.features
    sub = {k: v["features"] for k, v in variables.items()}
    layout = pm.layout
    if version == "v1":
        jbody, form = jdark1.DarknetBodyV1(layout), {}
    elif version == "v2":
        jbody, form = jdark2.DarknetBodyV2(layout, passthrough=True), {"passthrough": True}
    elif version == "v3":
        jbody, form = jdark3.DarknetBodyV3(layout, num_features=3), {"num_features": 3}
    else:
        kwargs = {"act_layer": jax.nn.mish, "drop_layer": JaxDropBlock2d} if version == "v4_mish" else {}
        jbody, form = jdark4.DarknetBodyV4(layout, num_features=3, **kwargs), {"num_features": 3}
    saved = {k: getattr(body, k) for k in form}
    for k, v in form.items():
        setattr(body, k, v)
    try:
        refs = jax.jit(jbody.apply)(sub, x)
        with torch.no_grad():
            outs = body(nchw(x))
    finally:
        for k, v in saved.items():
            setattr(body, k, v)
    refs = [refs] if version == "v1" else list(refs)
    outs = [outs] if version == "v1" else list(outs)
    assert len(outs) == len(refs) == {"v1": 1, "v2": 2}.get(version, 3)
    for i, (out, ref) in enumerate(zip(outs, refs)):
        _close(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), 1e-4, f"{version} body output {i}", rtol=1e-4)


@pytest.mark.parametrize(
    "arch,expected",
    [("darknet19", 19827626), ("darknet24", 22413386), ("darknet53", 40595178), ("cspdarknet53", 26627434),
     ("cspdarknet53_mish", 26627434)],
)
def test_darknet_param_counts(arch, expected):
    """Full width at the factories' default of 10 classes: the counts of
    ``tests/test_models_classification.py:144-147`` (cspdarknet53_mish: cspdarknet53's,
    its checkpoint's count). ``pretrained=True`` raises."""
    pm = getattr(models, arch)(device="meta")
    assert sum(p.numel() for p in pm.parameters()) == expected
    with pytest.raises(NotImplementedError):
        getattr(models, arch)(pretrained=True, device="meta")
