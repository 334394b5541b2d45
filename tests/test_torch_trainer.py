"""The port's ClassificationTrainer against the JAX package's, on the CPU in float32.

Both train the same small RepVGG (``RepVGG([1, 1], [8, 16], 1.0, 1.0)``, 10 classes,
32 px; weights carried by ``convert.repvgg_state_dict``) on the same uint8 batches,
through the step the classification reference builds (``references/classification/
train.py:204-302``): LAMB under a onecycle schedule, label smoothing 0.1 into
``multilabel_cross_entropy``, ImageNet ``input_norm``, ``gradient_clip=1.0``,
``gradient_acc=2`` and ``skip_nan_loss=True``. The JAX trainer runs on one CPU device.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu.nn.functional import multilabel_cross_entropy as jax_mce
from holocron_tpu.optim import lamb
from holocron_tpu.trainer import ClassificationTrainer as JaxTrainer
from holocron_tpu_torch import convert
from holocron_tpu_torch.models import RepVGG
from holocron_tpu_torch.nn.functional import multilabel_cross_entropy
from holocron_tpu_torch.optim import LAMB
from holocron_tpu_torch.trainer import ClassificationTrainer

torch.set_num_threads(2)

CFG = ([1, 1], [8, 16], 1.0, 1.0)
NUM_CLASSES, BATCH, SIZE, LR = 10, 4, 32, 0.05
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
KWARGS = {"gradient_acc": 2, "gradient_clip": 1.0, "skip_nan_loss": True, "input_norm": IMAGENET}


def jax_criterion(out, target):
    target = jax.nn.one_hot(target, NUM_CLASSES, dtype=out.dtype)
    return jax_mce(out, target * 0.9 + 0.1 / NUM_CLASSES)


def port_criterion(out, target):
    target = torch.nn.functional.one_hot(target.long(), NUM_CLASSES).to(out.dtype)
    return multilabel_cross_entropy(out, target * 0.9 + 0.1 / NUM_CLASSES)


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8),
             rng.integers(0, NUM_CLASSES, size=(BATCH,)).astype(np.int32)) for _ in range(n)]


def _nchw(batches):
    return [(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), torch.from_numpy(y).long())
            for x, y in batches]


def _port_trainer(jax_variables, train, val, **kwargs):
    model = RepVGG(*CFG, num_classes=NUM_CLASSES, device="cpu")
    model.load_state_dict(convert.repvgg_state_dict(jax_variables))
    return ClassificationTrainer(model, train, val, port_criterion, functools.partial(LAMB, weight_decay=5e-5),
                                 device="cpu", **kwargs)


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items() if "num_batches" not in k}


@pytest.fixture(scope="module")
def runs():
    """One epoch of 5 batches in both packages, step by step, then evaluate() on 2
    batches, then one step on a float32 batch holding a NaN."""
    train, val = _batches(5, 0), _batches(2, 1)
    jm = Model(JaxRepVGG(*CFG, num_classes=NUM_CLASSES)).init((BATCH, SIZE, SIZE, 3), key=jax.random.key(0))
    init_vars = jax.tree.map(np.asarray, jm.variables)
    jt = JaxTrainer(jm, train, val, jax_criterion, lambda lr: lamb(lr=lr, weight_decay=5e-5),
                    devices=jax.devices()[:1], **KWARGS)
    pt = _port_trainer(init_vars, _nchw(train), _nchw(val), **KWARGS)

    schedule = jt._make_schedule(LR, len(train), "onecycle")
    jt._reset_opt(schedule)
    pt._reset_opt(pt._make_schedule(LR, len(train), "onecycle"))
    losses = [(jt._run_step(x, y), pt._run_step(tx, ty)) for (x, y), (tx, ty) in zip(train, _nchw(train))]
    after_epoch = (convert.repvgg_state_dict(jax.tree.map(np.asarray, jt.model.variables)), _state(pt))
    metrics = (jt.evaluate(), pt.evaluate())

    x_nan = np.random.default_rng(2).normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    x_nan[0, 0, 0, 0] = np.nan
    y = train[0][1]
    jparams = jax.tree.map(np.asarray, jt.model.params)
    jcount = int(jt._opt_state.inner_state.gradient_step)
    pparams = {k: v.detach().clone() for k, v in pt.model.named_parameters()}
    pcount = pt._opt.param_groups[0]["count"]
    nan_losses = (jt._run_step(x_nan, y), pt._run_step(torch.from_numpy(x_nan.transpose(0, 3, 1, 2).copy()),
                                                      torch.from_numpy(y).long()))
    nan_step = {
        "jax_params_kept": all(np.array_equal(a, np.asarray(b)) for a, b in
                               zip(jax.tree.leaves(jparams), jax.tree.leaves(jt.model.params))),
        "jax_count": (jcount, int(jt._opt_state.inner_state.gradient_step)),
        "port_params_kept": all(torch.equal(v, dict(pt.model.named_parameters())[k]) for k, v in pparams.items()),
        "port_count": (pcount, pt._opt.param_groups[0]["count"]),
        "losses": nan_losses,
        "skipped": pt.skipped_steps,
    }
    return {"losses": losses, "after_epoch": after_epoch, "metrics": metrics, "nan_step": nan_step,
            "init_vars": init_vars, "data": (train, val)}


def test_per_step_losses_match_jax(runs):
    jax_losses, port_losses = zip(*runs["losses"])
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert len(set(port_losses)) == len(port_losses)  # the params moved between steps


def test_params_and_bn_statistics_after_the_epoch_match_jax(runs):
    theirs, ours = runs["after_epoch"]
    start = convert.repvgg_state_dict(runs["init_vars"])
    moved = 0
    for key, value in ours.items():
        np.testing.assert_allclose(value.numpy(), theirs[key].numpy(), rtol=0, atol=1e-4, err_msg=key)
        moved += not torch.equal(value, start[key])
    assert moved == len(ours)  # every parameter and statistic was updated


def test_evaluate_matches_jax(runs):
    theirs, ours = runs["metrics"]
    assert ours["acc1"] == theirs["acc1"] and ours["acc5"] == theirs["acc5"]
    assert math.isclose(ours["val_loss"], theirs["val_loss"], rel_tol=1e-5)


def test_non_finite_step_is_skipped_in_both(runs):
    """The NaN step gives a NaN loss and changes no parameter and no inner count; the
    two packages had applied the same number of updates (2 of 5 batches at acc 2)."""
    nan = runs["nan_step"]
    assert all(math.isnan(v) for v in nan["losses"])
    assert nan["jax_params_kept"] and nan["port_params_kept"]
    assert nan["jax_count"] == nan["port_count"] == (2, 2)
    assert nan["skipped"] == 1


def test_fit_save_load_roundtrip(runs, tmp_path):
    """fit_n_epochs trains, evaluates and saves the best state; load restores the
    model, epoch and step into a fresh trainer."""
    train, val = runs["data"]
    pt = _port_trainer(runs["init_vars"], _nchw(train), _nchw(val), output_file=str(tmp_path / "best.pt"), **KWARGS)
    pt.fit_n_epochs(1, LR)
    assert (pt.epoch, pt.step) == (1, 5) and (tmp_path / "best.pt").exists()
    fresh = _port_trainer(runs["init_vars"], _nchw(train), _nchw(val), **KWARGS)
    fresh.load(str(tmp_path / "best.pt"))
    assert (fresh.epoch, fresh.step, fresh.min_loss) == (1, 5, pt.min_loss)
    assert all(torch.equal(a, b) for a, b in zip(_state(fresh).values(), _state(pt).values()))


def test_amp_keeps_float32_master_params(runs):
    train, val = runs["data"]
    pt = _port_trainer(runs["init_vars"], _nchw(train), _nchw(val), amp=True, **KWARGS)
    losses = pt.check_setup(lr=LR, num_it=4)
    assert all(math.isfinite(v) for v in losses)
    assert all(p.dtype == torch.float32 for p in pt.model.parameters())
    assert all(b.dtype == torch.float32 for n, b in pt.model.named_buffers() if "running" in n)
    assert pt.evaluate()["acc5"] >= 0.0


def test_freeze_until_keeps_frozen_params_and_statistics(runs):
    train, val = runs["data"]
    pt = _port_trainer(runs["init_vars"], _nchw(train), _nchw(val), gradient_clip=1.0, input_norm=IMAGENET)
    before = _state(pt)
    pt._reset_opt(LR, norm_weight_decay=0.0, freeze_until="features.0")
    pt._run_step(*_nchw(train)[0])
    after = _state(pt)
    assert all(torch.equal(before[k], after[k]) for k in before if k.startswith("features.0."))
    assert not torch.equal(before["head.weight"], after["head.weight"])
    assert not torch.equal(before["features.1.0.branches.0.1.running_mean"],
                           after["features.1.0.branches.0.1.running_mean"])
    with pytest.raises(ValueError):
        pt._reset_opt(LR, freeze_until="not_a_layer")


def test_profile_names_the_step_ranges(runs):
    """Trainer.profile traces train steps with the forward, backward and update as
    ranges of their own (on the CPU: host time only)."""
    train, val = runs["data"]
    pt = _port_trainer(runs["init_vars"], _nchw(train), _nchw(val), **KWARGS)
    prof = pt.profile(num_steps=2, lr=LR)
    keys = {e.key for e in prof.key_averages()}
    assert {"train_step.forward", "train_step.backward", "train_step.update"} <= keys
    assert pt._opt.param_groups[0]["count"] == 1  # 3 steps at gradient_acc=2
