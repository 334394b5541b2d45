"""Parity of the PyTorch port's RepVGG with the JAX package, on the CPU in float32.

The JAX package makes the weights; ``holocron_tpu_torch.convert`` carries them across.
Inputs come from numpy with a fixed seed; the port takes NCHW, JAX NHWC.
"""

import urllib.request

import jax
import numpy as np
import pytest
import torch

from holocron_tpu.models._torch_convert import convert_state_dict
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu_torch import convert
from holocron_tpu_torch.models import RepVGG, repvgg_a0

torch.set_num_threads(2)

CFG = ([1, 1], [8, 16], 1.0, 1.0)  # two stages, widths 8 and 16


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """No network: fetching a release URL fails as it does offline, into an empty cache."""
    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("HOLOCRON_CACHE_DIR", str(tmp_path))


def _randomize_bn(variables, rng):
    """Non-trivial BN parameters and statistics, so that fusion is exercised."""

    def visit(params, stats):
        for name, node in params.items():
            if "scale" in node and "bias" in node and not isinstance(node["bias"], dict):
                c = node["scale"].shape[0]
                params[name] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                                "bias": rng.normal(0, 0.1, c).astype(np.float32)}
                stats[name] = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                               "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            elif isinstance(node, dict) and name in stats:
                visit(node, stats[name])

    variables = jax.tree.map(np.asarray, variables)
    visit(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def pair():
    """A JAX model and the port model with the same train-form weights, plus an input."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = Model(JaxRepVGG(*CFG)).init(x.shape, key=jax.random.key(0))
    jm.load_variables(_randomize_bn(jm.variables, rng))
    pm = RepVGG(*CFG, device="cpu")
    pm.load_state_dict(convert.repvgg_state_dict(jm.variables))
    return jm, pm, x


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_train_form_logits_match_jax(pair):
    jm, pm, x = pair
    pm.eval()
    with torch.no_grad():
        out = pm(_nchw(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm(x)), rtol=1e-4, atol=1e-5)


def test_bn_train_step_and_deploy_match_jax(pair):
    """One train-mode step: outputs and every BN running statistic agree (atol 1e-5);
    then the reparametrized models agree (atol 1e-5), and the port's own
    train-form-eval to deploy drift stays within 1e-3 (docs/ARCHITECTURE.md:58)."""
    jm, pm, x = pair
    jm = Model(jm.module, jax.tree.map(np.asarray, jm.variables))
    pm = RepVGG(*CFG, device="cpu")
    pm.load_state_dict(convert.repvgg_state_dict(jm.variables))

    pm.train()
    with torch.no_grad():
        out_train = pm(_nchw(x)).numpy()
    np.testing.assert_allclose(out_train, np.asarray(jm(x, train=True)), rtol=1e-4, atol=1e-5)
    ported = convert.repvgg_state_dict(jm.variables)
    sd = pm.state_dict()
    stat_keys = [k for k in ported if k.endswith(("running_mean", "running_var"))]
    assert stat_keys
    for key in stat_keys:
        np.testing.assert_allclose(sd[key].numpy(), ported[key].numpy(), atol=1e-5, err_msg=key)

    pm.eval()
    x2 = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    with torch.no_grad():
        before = pm(_nchw(x2)).numpy()
        pm.reparametrize()
        after = pm(_nchw(x2)).numpy()
    assert np.abs(before - after).max() <= 1e-3
    jm.reparametrize()
    np.testing.assert_allclose(after, np.asarray(jm(x2)), atol=1e-5)

    # deploy-form weights carried across directly give the same model
    deployed = RepVGG(*CFG, device="cpu").reparametrize()
    deployed.load_state_dict(convert.repvgg_state_dict(jm.variables))
    with torch.no_grad():
        np.testing.assert_allclose(deployed.eval()(_nchw(x2)).numpy(), np.asarray(jm(x2)), atol=1e-5)


def test_state_dict_round_trip_through_jax_converter(pair):
    """JAX variables -> port state_dict -> holocron_tpu's own torch converter -> the
    same JAX variables, exactly."""
    jm, _, _ = pair
    pm = RepVGG(*CFG, device="cpu")
    pm.load_state_dict(convert.repvgg_state_dict(jm.variables))
    back = convert_state_dict(jm, pm.state_dict())
    orig = jax.tree.map(np.asarray, jm.variables)
    assert jax.tree.structure(back) == jax.tree.structure(orig)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(orig)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_repvgg_a0_layout_matches_jax_param_count(offline):
    """The full-width factory builds the same number of parameters as the JAX one and
    the state_dict keys the original Holocron layout."""
    pm = repvgg_a0(generator=torch.Generator().manual_seed(0), device="cpu")
    n_params = sum(p.numel() for p in pm.parameters())
    jm = Model(JaxRepVGG([1, 2, 4, 14, 1], [64, 64, 128, 256, 512], 0.75, 2.5))
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.key(0), jax.numpy.zeros((1, 32, 32, 3))))
    assert n_params == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    keys = pm.state_dict().keys()
    assert "features.3.14.branches.2.running_var" in keys and "head.weight" in keys
    offline = repvgg_a0(pretrained=True, device="meta")
    assert not offline.pretrained_loaded and offline.default_cfg.meta.arch == "repvgg_a0"


def test_init_is_seeded():
    a = RepVGG(*CFG, generator=torch.Generator().manual_seed(3), device="cpu").state_dict()
    b = RepVGG(*CFG, generator=torch.Generator().manual_seed(3), device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["features.1.0.branches.0.0.weight"]  # fan-out He-normal: std = sqrt(2 / (16 * 9))
    assert abs(float(w.std()) - (2 / (16 * 9)) ** 0.5) < 0.02
