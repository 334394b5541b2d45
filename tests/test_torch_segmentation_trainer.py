"""The port's segmentation training path against the JAX package's, on the CPU in
float32: AdamP, AdaBelief, AdamW and RAdam step by step against their optax
trajectories; ``SegmentationTrainer.evaluate``'s metrics; ``find_lr``'s recorders;
``SyntheticDataset``, ``normalize_image`` and ``Resize``; and the segmentation CLI's
``main()`` on ``fake`` data with ``--device cpu``.

The trainers run a narrow UNet (``(4, 8)``, 16 px, batch 8: the JAX trainer's 8-device
CPU mesh takes it unpadded), its weights carried by
``convert.segmentation_state_dict``; ``evaluate`` runs an identity model on given
logits, so that both packages count the same predictions.

Tolerances: the optimizers' parameters within atol 1e-6 after each step (RAdam's
denominator adds eps to ``sqrt(v) / sqrt(1 - b2^t)`` in optax and to ``sqrt(v)`` in
torch, a difference below that); the metrics and the learning rates exact, the val
loss and the sweep's losses within 1e-5 relative; samples equal; resized images within
1e-6 of 255 (bilinear, float), masks and PIL images equal.
"""

import math

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from test_torch_resnet import nchw

from holocron_tpu import optim as joptim
from holocron_tpu.models.core import Model
from holocron_tpu.models.segmentation.unet import UNet as JaxUNet
from holocron_tpu.nn import functional as JF
from holocron_tpu.trainer import SegmentationTrainer as JaxSegmentationTrainer
from holocron_tpu.transforms import Resize as JaxResize
from holocron_tpu.transforms import ResizeMethod as JaxResizeMethod
from holocron_tpu.utils.data import SyntheticDataset as JaxSyntheticDataset
from holocron_tpu.utils.data import normalize_image as jax_normalize_image
from holocron_tpu_torch import convert, optim
from holocron_tpu_torch.models.segmentation import UNet
from holocron_tpu_torch.nn import functional as F
from holocron_tpu_torch.references.segmentation import train as cli
from holocron_tpu_torch.trainer import SegmentationTrainer
from holocron_tpu_torch.transforms import Resize, ResizeMethod
from holocron_tpu_torch.utils.data import SyntheticDataset, normalize_image

torch.set_num_threads(2)

SHAPES = {"w": (4, 3), "b": (3,), "k": (2, 3, 3, 3)}


def _halving(count):
    return 1e-2 * 0.5**count


OPTIMIZERS = {
    "adamp": (lambda **kw: joptim.adamp(**kw), lambda params, **kw: optim.AdamP(params, **kw), {"lr": 1e-2}),
    "adamp-decay-schedule": (lambda **kw: joptim.adamp(**kw), lambda params, **kw: optim.AdamP(params, **kw),
                             {"lr": _halving, "weight_decay": 1e-2, "delta": 0.3}),
    "adamp-amsgrad": (lambda **kw: joptim.adamp(**kw), lambda params, **kw: optim.AdamP(params, **kw),
                      {"lr": 1e-2, "amsgrad": True}),
    "adabelief": (lambda **kw: joptim.adabelief(**kw), lambda params, **kw: optim.AdaBelief(params, **kw),
                  {"lr": 1e-2}),
    "adabelief-decay-schedule-amsgrad": (
        lambda **kw: joptim.adabelief(**kw), lambda params, **kw: optim.AdaBelief(params, **kw),
        {"lr": _halving, "weight_decay": 1e-2, "amsgrad": True}),
    # the CLI's adamw: optax.adamw(lr, weight_decay=wd)
    "adamw": (lambda lr, weight_decay: optax.adamw(lr, weight_decay=weight_decay),
              lambda params, lr, weight_decay: optim.AdamW(params, lr, weight_decay=weight_decay),
              {"lr": _halving, "weight_decay": 1e-2}),
    # the CLI's radam: decay added to the gradient, then optax.radam (rectified from step 6)
    "radam": (lambda lr, weight_decay: optax.chain(optax.add_decayed_weights(weight_decay),
                                                   optax.radam(lr, b1=0.95, b2=0.99, eps=1e-6)),
              lambda params, lr, weight_decay: optim.RAdam(params, lr, betas=(0.95, 0.99), eps=1e-6,
                                                           weight_decay=weight_decay),
              {"lr": 1e-2, "weight_decay": 1e-2}),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Eight steps on the same gradients (AdamP's projection taken by some parameters
    and not others): the parameters within atol 1e-6 after each, the counts equal."""
    make_jax, make_port, kwargs = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(8)]
    tx = make_jax(**kwargs)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_port(list(tparams.values()), **kwargs)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6, err_msg=k)
    assert opt.param_groups[0]["count"] == 8


class _JaxIdentity(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x, train: bool = False):
        return x


def test_evaluate_matches_jax():
    """Given logits through an identity model in both trainers (21 classes, 255 in a
    fifth of the targets, one batch whose targets are all 255 and whose loss is NaN):
    ``val_loss``, ``acc_global`` and ``mean_iou`` as the JAX package's."""
    nc = 21
    rng = np.random.default_rng(1)
    batches = []
    for b in range(3):
        logits = rng.normal(size=(8, 6, 7, nc)).astype(np.float32)
        target = rng.integers(0, nc, size=(8, 6, 7)).astype(np.int32)
        target[rng.random(target.shape) < 0.2] = 255
        if b == 2:
            target[:] = 255
        batches.append((logits, target))

    def jax_criterion(out, tgt):
        return JF.cross_entropy(out, tgt, ignore_index=255)

    jt = JaxSegmentationTrainer(Model(_JaxIdentity()), None, batches, jax_criterion, None, num_classes=nc)
    expected = jt.evaluate()
    port_val = [(nchw(x), torch.from_numpy(t).long()) for x, t in batches]
    pt = SegmentationTrainer(torch.nn.Identity(), None, port_val,
                             lambda out, tgt: F.cross_entropy(out.permute(0, 2, 3, 1), tgt, ignore_index=255),
                             None, device="cpu", num_classes=nc)
    got = pt.evaluate()
    assert set(got) == {"val_loss", "acc_global", "mean_iou"}
    assert got["acc_global"] == expected["acc_global"] and got["mean_iou"] == expected["mean_iou"]
    assert math.isclose(got["val_loss"], expected["val_loss"], rel_tol=1e-5)
    assert "Mean IoU" in SegmentationTrainer._eval_metrics_str(got)


def _unet_pair(batches):
    """A narrow UNet in both packages on the same weights, each in its trainer with
    AdaBelief and cross-entropy (255 ignored)."""
    x = batches[0][0]
    module = JaxUNet([4, 8], num_classes=3)
    variables = jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.key(0), x))
    pm = UNet([4, 8], num_classes=3, device="cpu")
    pm.load_state_dict(convert.segmentation_state_dict(variables, pm))
    jt = JaxSegmentationTrainer(Model(module, variables), batches, batches,
                                lambda out, tgt: JF.cross_entropy(out, tgt, ignore_index=255),
                                lambda lr: joptim.adabelief(lr=lr), num_classes=3)
    port_batches = [(nchw(xb), torch.from_numpy(t).long()) for xb, t in batches]
    pt = SegmentationTrainer(pm, port_batches, port_batches,
                             lambda out, tgt: F.cross_entropy(out.permute(0, 2, 3, 1), tgt, ignore_index=255),
                             lambda groups, lr: optim.AdaBelief(groups, lr), device="cpu", num_classes=3)
    return jt, pt


def test_find_lr_matches_jax():
    """The learning-rate sweep over 4 batches: the same ``lr_recorder`` and, step by
    step, the same losses; the optimizer's count at 4; too many iterations raise."""
    rng = np.random.default_rng(2)
    batches = [(rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                rng.integers(0, 3, size=(8, 16, 16)).astype(np.int32)) for _ in range(4)]
    jt, pt = _unet_pair(batches)
    jt.find_lr(start_lr=1e-4, end_lr=1.0, num_it=4)
    pt.find_lr(start_lr=1e-4, end_lr=1.0, num_it=4)
    assert pt.lr_recorder == jt.lr_recorder and len(pt.lr_recorder) == 4
    np.testing.assert_allclose(pt.loss_recorder, jt.loss_recorder, rtol=1e-5)
    assert pt._opt.param_groups[0]["count"] == 4
    with pytest.raises(ValueError, match="num_it"):
        pt.find_lr(num_it=5)


@pytest.mark.parametrize("task", ["classification", "segmentation", "detection"])
def test_synthetic_dataset_matches_jax(task):
    """Sample for sample, the JAX package's draws, the image channel-first."""
    jds = JaxSyntheticDataset(5, (12, 10, 3), 7, task=task)
    pds = SyntheticDataset(5, (3, 12, 10), 7, task=task)
    assert len(pds) == len(jds) == 5
    for idx in range(5):
        (jx, jy), (px, py) = jds[idx], pds[idx]
        np.testing.assert_array_equal(px.numpy(), jx.transpose(2, 0, 1))
        if task == "classification":
            assert py == jy
        elif task == "segmentation":
            assert py.dtype == torch.int64
            np.testing.assert_array_equal(py.numpy(), jy)
        else:
            np.testing.assert_array_equal(py["boxes"], jy["boxes"])
            np.testing.assert_array_equal(py["labels"], jy["labels"])


def test_normalize_image_matches_jax():
    img = np.random.default_rng(3).integers(0, 256, size=(9, 11, 3)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_array_equal(normalize_image(img, mean, std).numpy(),
                                  jax_normalize_image(img, mean, std).transpose(2, 0, 1))


@pytest.mark.parametrize("mode", ["squish", "pad"])
def test_resize_matches_jax(mode):
    """The folder reader's resizes: images bilinear (PIL images by PIL in both; float
    arrays), masks half-pixel nearest on the CLI's uint8 palette arrays (37 x 53 -> 256
    x 256, and 64 x 48 -> 32 x 40, a shrink)."""
    rng = np.random.default_rng(4)
    for shape, size in (((37, 53), (256, 256)), ((64, 48), (32, 40))):
        kw = {"mode": ResizeMethod(mode)}
        jkw = {"mode": JaxResizeMethod(mode)}
        pil = Image.fromarray(rng.integers(0, 256, size=(*shape, 3)).astype(np.uint8))
        np.testing.assert_array_equal(np.asarray(Resize(size, **kw)(pil)), np.asarray(JaxResize(size, **jkw)(pil)))
        arr = (rng.random((*shape, 3)) * 255).astype(np.float32)
        np.testing.assert_allclose(Resize(size, **kw)(arr), JaxResize(size, **jkw)(arr), rtol=0, atol=255e-6)
        mask = rng.integers(0, 21, size=(*shape, 1)).astype(np.uint8)
        mask[rng.random(mask.shape) < 0.1] = 255
        got = Resize(size, interpolation="nearest", **kw)(mask)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, JaxResize(size, interpolation="nearest", **jkw)(mask))


def _cli(tmp_path, *flags):
    args = cli.parse_args(["fake", "--device", "cpu", "--crop-size", "32", "-b", "2", "--fake-samples", "4",
                           "--epochs", "1", "-j", "0", "--output-file", str(tmp_path / "seg.pt"), *flags])
    return cli.main(args)


@pytest.mark.parametrize(
    "flags",
    [
        [],  # the defaults: unet3p, cross-entropy, AdamP, onecycle
        ["--loss", "focal", "--opt", "adabelief", "--bg-factor", "0.5"],
        ["--loss", "dice", "--opt", "radam", "--arch", "unet2", "--num-classes", "4"],
        ["--loss", "crossentropy", "--opt", "adamw", "--arch", "unet", "--sched", "cosine", "--amp"],
    ],
    ids=["crossentropy-adamp", "focal-adabelief", "dice-radam", "adamw-amp"],
)
def test_cli_trains_an_epoch_on_cpu(tmp_path, flags):
    """``main()`` on ``fake`` at 32 px: an epoch of 2 batches, ``evaluate()`` finite,
    the best state saved; then ``--test-only`` from it with ``--resume``."""
    trainer = _cli(tmp_path, *flags)
    assert trainer._opt.param_groups[0]["count"] == 2
    assert math.isfinite(trainer.min_loss) and (tmp_path / "seg.pt").exists()
    resumed = _cli(tmp_path, *flags, "--test-only", "--resume", str(tmp_path / "seg.pt"))
    assert resumed.epoch == 1


def test_cli_find_lr_check_setup_and_one_device(tmp_path, capsys):
    """``--find-lr`` prints the sweep (2 batches), ``--check-setup`` the overfit losses;
    the parallel flags raise at any value but their default."""
    trainer = _cli(tmp_path, "--arch", "unet", "--find-lr")
    assert len(trainer.lr_recorder) == len(trainer.loss_recorder) == 2
    _cli(tmp_path, "--arch", "unet_rexnet13", "--opt", "adamw", "--check-setup")  # 20 steps
    out = capsys.readouterr().out
    assert out.count("\nlr=") == 2 and "overfit-one-batch losses" in out
    for flags in (["--model-parallel", "2"], ["--spatial-parallel", "2"], ["--shard-opt-state"]):
        with pytest.raises(NotImplementedError):
            _cli(tmp_path, *flags)
