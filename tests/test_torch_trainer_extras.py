"""The trainer's remaining options on the CPU: ``remat``, ``prefetch``, the plots and the
binary trainer, against the port without them and against the JAX package.

Tolerances: ``remat`` recomputes the same float32 operations, so losses and gradients
agree within 1e-6 (they come out equal here); the binary trainer's ``evaluate()`` holds
the JAX one's within 1e-5 on the same converted weights (float32 convs in two layouts);
the top-loss collection's images within 1e-6 and its titles (losses to 3 digits,
predictions, probabilities, targets) equal.
"""

import copy

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from holocron_tpu import optim as jax_optim
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu.nn import FocalLoss as JaxFocalLoss
from holocron_tpu.trainer import BinaryClassificationTrainer as JaxBinaryTrainer
from holocron_tpu.trainer import ClassificationTrainer as JaxTrainer
from holocron_tpu_torch import convert
from holocron_tpu_torch.models import ConvNeXt, RepVGG, StochasticDepth
from holocron_tpu_torch.nn import FocalLoss
from holocron_tpu_torch.optim import LAMB
from holocron_tpu_torch.trainer import BinaryClassificationTrainer, ClassificationTrainer, core
from holocron_tpu_torch.utils.data import prefetch

matplotlib.use("Agg")
torch.set_num_threads(2)

CFG = ([1, 1], [8, 16], 1.0, 1.0)


def _batches(n, seed, num_classes=5, size=16, binary=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
        y = rng.integers(0, 2 if binary else num_classes, size=(4,))
        out.append((x, y.astype(np.float32 if binary else np.int32)))
    return out


def _nchw(batches, binary=False):
    return [(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
             torch.from_numpy(y) if binary else torch.from_numpy(y).long()) for x, y in batches]


def _repvgg(num_classes, seed=0):
    return RepVGG(*CFG, num_classes=num_classes, device="cpu", generator=torch.Generator().manual_seed(seed))


def _grads(model, remat, x, y, criterion=F.cross_entropy, amp=False):
    trainer = ClassificationTrainer(copy.deepcopy(model), [(x, y)], None, criterion, LAMB, device="cpu", remat=remat,
                                    amp=amp)
    trainer.model.train()
    loss = trainer._step_loss(x, y)
    grads = torch.autograd.grad(loss, list(trainer.model.parameters()), allow_unused=True)
    stats = {k: v.clone() for k, v in trainer.model.state_dict().items() if "running" in k or "num_batches" in k}
    return float(loss.detach()), grads, stats


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_remat_gives_the_same_loss_gradients_and_statistics(remat):
    """Loss and gradients of a RepVGG step under ``remat`` equal those without, and the
    batch norms' running statistics move once (``num_batches_tracked`` 1): the
    recomputation's update is undone."""
    x, y = _nchw(_batches(1, 0, size=32))[0]
    model = _repvgg(5)
    ref_loss, ref_grads, ref_stats = _grads(model, False, x, y)
    loss, grads, stats = _grads(model, remat, x, y)
    assert abs(loss - ref_loss) <= 1e-6
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)
    assert stats.keys() == ref_stats.keys() and all(int(v) == 1 for k, v in stats.items() if "num_batches" in k)
    for k, v in stats.items():
        assert torch.equal(v, ref_stats[k]), k


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_replays_stochastic_depth(remat):
    """A ConvNeXt whose stochastic depth draws from its own generator: the
    recomputation draws the same rows, so the gradients equal those without ``remat``;
    the generator ends where one forward leaves it."""
    model = ConvNeXt([1, 2], [8, 16], num_classes=5, stochastic_depth_prob=0.5, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    x, y = _nchw(_batches(1, 2, size=32))[0]

    def run(mode):
        m = copy.deepcopy(model)
        gen = torch.Generator().manual_seed(5)
        for mod in m.modules():
            if isinstance(mod, StochasticDepth):
                mod.generator = gen
        out = _grads(m, mode, x, y)
        return out, gen.get_state()

    (ref_loss, ref_grads, _), ref_state = run(False)
    (loss, grads, _), state = run(remat)
    assert loss == ref_loss and torch.equal(state, ref_state)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
def test_dots_policy_sees_and_keeps_convolutions_and_products(monkeypatch, amp):
    """The ops ``"dots"`` keeps are those it sees of the convolutions and matrix
    products: ``aten.convolution`` and ``aten.addmm`` (the linear head) in float32 and
    under the trainer's bf16 ``amp``, and the same under ``torch.autocast``."""
    seen, kept = set(), set()
    policy = core._dots_saveable

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        seen.add(str(op))
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            kept.add(str(op))
        return decision

    monkeypatch.setattr(core, "_dots_saveable", recording)
    x, y = _nchw(_batches(1, 0, size=32))[0]
    _grads(_repvgg(5), "dots", x, y, amp=amp)
    assert kept == {"aten.convolution.default", "aten.addmm.default"}
    assert {"aten.native_batch_norm.default", "aten.relu.default"} <= seen or {"aten._native_batch_norm_legit.default",
                                                                              "aten.relu.default"} <= seen
    kept.clear()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        _grads(_repvgg(5), "dots", x, y)
    assert kept == {"aten.convolution.default", "aten.addmm.default"}


def test_remat_refuses_other_values():
    with pytest.raises(ValueError, match="remat"):
        ClassificationTrainer(_repvgg(5), device="cpu", remat="bogus")


def test_prefetch_places_ahead_and_keeps_the_trajectory():
    """``prefetch`` applies its function ``size`` items ahead of the one it hands out
    (``loader.py:21-42``: two placed while the first is consumed), in order; a trainer's
    epoch (which places its batches through it) takes the same steps as the same
    batches stepped one by one."""
    calls = []
    it = prefetch(range(5), lambda v: calls.append(v) or v * 10, size=2)
    assert next(it) == 0 and calls == [0, 1, 2]
    assert list(it) == [10, 20, 30, 40] and calls == [0, 1, 2, 3, 4]
    batches = _nchw(_batches(4, 3))
    model = _repvgg(5)
    a = ClassificationTrainer(copy.deepcopy(model), batches, None, F.cross_entropy, LAMB, device="cpu")
    b = ClassificationTrainer(copy.deepcopy(model), batches, None, F.cross_entropy, LAMB, device="cpu")
    a._reset_opt(1e-2)
    b._reset_opt(1e-2)
    a._fit_epoch()
    for x, y in batches:
        b._run_step(x, y)
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k


def _jax_and_port(num_classes, train, val, jax_cls, port_cls, jax_criterion, port_criterion):
    jm = Model(JaxRepVGG(*CFG, num_classes=num_classes)).init((4, 16, 16, 3), key=jax.random.key(0))
    jt = jax_cls(jm, train, val, jax_criterion, lambda lr: jax_optim.adabelief(lr=lr), devices=jax.devices()[:1])
    model = RepVGG(*CFG, num_classes=num_classes, device="cpu")
    model.load_state_dict(convert.repvgg_state_dict(jax.tree.map(np.asarray, jm.variables)))
    pt = port_cls(model, _nchw(train, jax_cls is JaxBinaryTrainer), _nchw(val, jax_cls is JaxBinaryTrainer),
                  port_criterion, LAMB, device="cpu")
    return jt, pt


def test_binary_trainer_evaluate_equals_jax():
    """``BinaryClassificationTrainer.evaluate`` on one output and 0/1 targets: the loss
    and the accuracy of the JAX one on the same weights; a step casts the targets to the
    logits' dtype and shape."""
    def jax_bce(out, target):
        return jnp.mean(jnp.maximum(out, 0) - out * target + jnp.log1p(jnp.exp(-jnp.abs(out))))

    train, val = _batches(2, 0, binary=True), _batches(2, 1, binary=True)
    jt, pt = _jax_and_port(1, train, val, JaxBinaryTrainer, BinaryClassificationTrainer, jax_bce,
                           F.binary_cross_entropy_with_logits)
    ours, theirs = pt.evaluate(), jt.evaluate()
    assert set(ours) == {"val_loss", "acc"}
    assert abs(ours["val_loss"] - theirs["val_loss"]) <= 1e-5 and abs(ours["acc"] - theirs["acc"]) <= 1e-5
    assert "Acc:" in pt._eval_metrics_str(ours)
    pt._reset_opt(1e-3)
    assert np.isfinite(pt._run_step(*pt.train_loader[0]))


def _titles(fig):
    return [ax.title.get_text() for ax in fig.axes if ax.title.get_text()]


def test_plots_and_top_losses_equal_jax(monkeypatch):
    """``plot_recorder`` after ``find_lr``, and ``plot_top_losses`` with a focal loss
    (its ``reduction`` set to "none" for the collection): the same twelve samples in the
    same order as the JAX trainer's, the same titles, the same images."""
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda **kwargs: None)
    train, val = _batches(4, 0), _batches(1, 1)
    jt, pt = _jax_and_port(5, train, val, JaxTrainer, ClassificationTrainer, JaxFocalLoss(gamma=2.0),
                           FocalLoss(gamma=2.0))
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    classes = [str(i) for i in range(5)]
    top = pt.top_losses(mean, std)
    assert len(top["losses"]) == 12 and np.all(np.diff(top["losses"]) <= 0)
    pt.plot_top_losses(mean, std, classes)
    ours = plt.gcf()
    jt.plot_top_losses(mean, std, classes)
    theirs = plt.gcf()
    assert _titles(ours) == _titles(theirs) and len(_titles(ours)) == 12
    for a, b in zip([ax for ax in ours.axes if ax.images], [ax for ax in theirs.axes if ax.images]):
        np.testing.assert_allclose(np.asarray(a.images[0].get_array()), np.asarray(b.images[0].get_array()),
                                   rtol=0, atol=1e-6)
    plt.close("all")
    with pytest.raises(AssertionError):
        pt.plot_top_losses(mean, std)
    with pytest.raises(AssertionError):
        pt.plot_recorder()
    pt.find_lr(num_it=4)
    pt.plot_recorder()
    assert plt.gca().get_xscale() == "log" and len(plt.gca().lines) == 1
    plt.close("all")
