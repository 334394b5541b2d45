"""The port's TAdam and DetectionTrainer against the JAX package's, on the CPU in float32.

TAdam: five steps on the same gradients against its optax trajectory. The trainer: a
narrow YOLOv2 (``drop_layer=None``, so that no random draw differs; 3 classes, 64 px;
weights carried by ``convert.detection_state_dict``) in both packages' trainers with
TAdam, on the same batches and ground truth padded to 50 boxes (the detection
reference's ``max_boxes``): ``evaluate()``'s counters on the same weights, then the
losses of each step side by side, then an epoch through ``fit_n_epochs``.

Tolerances: TAdam's parameters within atol 1e-6 after each step; the step losses
within 1e-4 relative; ``assign_iou`` and the evaluation counters identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models_detection import _make_targets
from test_torch_resnet import nchw

from holocron_tpu import optim as joptim
from holocron_tpu.models.detection import pad_targets as jax_pad_targets
from holocron_tpu.models.detection.yolo import DetectionModel as JaxDetectionModel
from holocron_tpu.models.detection.yolov2 import YOLOv2 as JaxYOLOv2
from holocron_tpu.trainer import DetectionTrainer as JaxDetectionTrainer
from holocron_tpu.trainer.detection import assign_iou as jax_assign_iou
from holocron_tpu_torch import convert
from holocron_tpu_torch.models.detection import YOLOv2, pad_targets
from holocron_tpu_torch.optim import TAdam
from holocron_tpu_torch.trainer import DetectionTrainer, assign_iou

torch.set_num_threads(2)

SHAPES = {"w": (4, 3), "b": (3,), "z": (5,)}
LAYOUT = [(8, 0), (16, 1), (16, 0), (32, 1), (32, 1)]
NUM_CLASSES, BATCH, SIZE, MAX_BOXES, LR = 3, 2, 64, 50, 1e-3


def _halving(count):
    return 1e-2 * 0.5**count


@pytest.mark.parametrize(
    "kwargs",
    [{"lr": 1e-2}, {"lr": _halving, "weight_decay": 1e-2}, {"lr": 1e-2, "amsgrad": True, "dof": 3.0}],
    ids=["plain", "decay-schedule", "amsgrad-dof"],
)
def test_tadam_matches_optax(kwargs):
    """Five steps on the same gradients: the parameters within atol 1e-6 after each,
    the counts equal."""
    rng = np.random.default_rng(0)
    init = {k: (np.zeros(s) if k == "z" else rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(5)]
    tx = joptim.tadam(**kwargs)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = TAdam(list(tparams.values()), **kwargs)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-6)
    assert opt.param_groups[0]["count"] == int(state.count) == 5
    with pytest.raises(ValueError):
        TAdam(list(tparams.values()), lr=-1.0)


def test_assign_iou_matches_jax():
    """Random boxes with several ground truths on one prediction (the tie-breaking
    branch), and a threshold none reaches."""
    rng = np.random.default_rng(2)
    gt = rng.random((6, 4)).astype(np.float32) * 0.5
    gt[:, 2:] += gt[:, :2] + 0.2
    pred = np.concatenate([gt[:2] + 0.01, gt[3:4] + 0.05, rng.random((3, 4)).astype(np.float32)])
    pred[3:, 2:] = pred[3:, :2] + 0.1
    gt[4] = gt[3] + 0.02  # two boxes on prediction 2
    for thresh in (0.5, 0.3, 0.99):
        ours, theirs = assign_iou(gt, pred, thresh), jax_assign_iou(gt, pred, thresh)
        assert [list(map(int, v)) for v in ours] == [list(map(int, v)) for v in theirs]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    rng = np.random.default_rng(3)
    xs = [rng.uniform(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32) for _ in range(4)]
    gts = [_make_targets([2, 1], NUM_CLASSES, seed=s) for s in range(3)]
    module = JaxYOLOv2(LAYOUT, num_classes=NUM_CLASSES)
    jm = JaxDetectionModel(module, max_boxes=MAX_BOXES)
    jm._ensure_init(jnp.asarray(xs[0]))
    pm = YOLOv2(LAYOUT, num_classes=NUM_CLASSES, device="cpu")
    pm.load_state_dict(convert.detection_state_dict(jax.tree.map(np.asarray, jm.variables), pm))
    # ground truth of the val batch: the model's own first detections, one relabeled,
    # so that evaluation assigns some and misclassifies one
    pm.eval()
    with torch.no_grad():
        dets = pm(nchw(xs[3]))
    val_gt = []
    for d in dets:
        labels = d["labels"][:3].copy()
        labels[:1] = (labels[:1] + 1) % NUM_CLASSES
        val_gt.append({"boxes": d["boxes"][:3], "labels": labels})
    jt = JaxDetectionTrainer(jm, [(x, jax_pad_targets(g, MAX_BOXES)) for x, g in zip(xs, gts)], [(xs[3], val_gt)],
                             None, lambda lr: joptim.tadam(lr=lr), devices=jax.devices()[:1])
    pt = DetectionTrainer(pm, [(nchw(x), pad_targets(g, MAX_BOXES)) for x, g in zip(xs, gts)], [(nchw(xs[3]), val_gt)],
                          None, TAdam, device="cpu",
                          output_file=str(tmp_path_factory.mktemp("det") / "checkpoint.pt"))
    return jt, pt, sum(len(d["boxes"]) for d in dets)


def test_detection_trainer_matches_jax(trainers):
    """``evaluate()`` on the same weights gives the same counters (on detections that
    exist, some assigned, one misclassified); then each TAdam step gives the same loss,
    finite, with padded slots in every target."""
    jt, pt, n_dets = trainers
    assert n_dets > 0
    ours, theirs = pt.evaluate(), jt.evaluate()
    assert ours == theirs
    assert ours["clf_err"] is not None and 0 < ours["clf_err"] < 1
    jt._reset_opt(LR)
    pt._reset_opt(LR)
    for (jx, jtarget), (px, ptarget) in zip(jt.train_loader, pt.train_loader):
        ours_loss, theirs_loss = pt._run_step(px, ptarget), jt._run_step(jx, jtarget)
        assert np.isfinite(ours_loss)
        np.testing.assert_allclose(ours_loss, theirs_loss, rtol=1e-4)


def test_detection_trainer_fits_an_epoch(trainers):
    """``fit_n_epochs`` (onecycle, TAdam) runs the loader's batches and evaluates: the
    four metrics, ``val_loss`` the localization error."""
    _, pt, _ = trainers
    seen = []
    pt.on_epoch_end = seen.append
    pt.fit_n_epochs(1, LR)
    assert pt._opt.param_groups[0]["count"] == len(pt.train_loader)
    assert set(seen[0]) == {"loc_err", "clf_err", "det_err", "val_loss"}
    assert seen[0]["val_loss"] == seen[0]["loc_err"]
    assert all(bool(torch.isfinite(p).all()) for p in pt.model.parameters())
    assert "Loc error" in pt._eval_metrics_str(seen[0])
