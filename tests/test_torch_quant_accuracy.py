"""The port's ``quant_accuracy`` against ``scripts/quant_accuracy.py`` on the CPU.

The JAX script is loaded from its file. Its ``jax.random`` draws are served from numpy
arrays in the order the script makes them (``jax.vmap`` over the images becomes a loop),
and the same arrays go to the port's ``*_images``: images within 1e-5, masks, labels and
boxes exactly. ``train`` runs both sides on one tiny RepVGG (``RepVGG([1], [8], 1.0,
1.0)``, 32 px, batch 4; the weights carried by ``convert.repvgg_state_dict``) over the
same fixed batches: parameters within rtol 1e-4 (atol 1e-6 for the few that Adam's first
steps leave near zero). The detection row is computed by both on the same cached raw
outputs: the rung and the row within 1e-6.

The gate's forms (``scripts/quant_accuracy.py:340-349``) on the same weights, a small
RepVGG and a narrow yolov4: the reference form's raw outputs within FORMS_RTOL of JAX's,
the int8 form float32 at every conv over JAX's ``qparams``, and one detector's whole gate
(forms, ladder, box-F1) at the same rung and within GATE_F1_TOL.
"""

import copy
import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resnet import randomize_bn

from holocron_tpu import quant as jquant
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu.models.detection.yolo import DetectionModel as JaxDetectionModel
from holocron_tpu_torch import convert, quant, quant_accuracy as qa
from holocron_tpu_torch.models import RepVGG

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CFG = ([1], [8], 1.0, 1.0)
NUM_CLASSES, BATCH, SIZE = 10, 4, 32


def _load_script():
    spec = importlib.util.spec_from_file_location("jax_quant_accuracy", ROOT / "scripts" / "quant_accuracy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_QA = _load_script()


class Draws:
    """Serves ``jax.random``'s draws from a queue of numpy arrays, checking each shape."""

    def __init__(self, monkeypatch):
        self.queue = []

        def pop(shape):
            value = self.queue.pop(0)
            assert value.shape == tuple(shape), (value.shape, shape)
            return value

        def vmap(fn):
            def looped(keys):
                outs = [fn(k) for k in keys]
                return jax.tree.map(lambda *a: jnp.stack(a), *outs)

            return looped

        monkeypatch.setattr(jax.random, "split", lambda key, num=2: [None] * num)
        monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=None: pop(shape))
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=None, minval=0.0, maxval=1.0: pop(shape))
        monkeypatch.setattr(jax.random, "randint", lambda key, shape, minval, maxval, dtype=None: pop(shape))
        monkeypatch.setattr(jax, "vmap", vmap)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_images(port_x, jax_x):
    np.testing.assert_allclose(port_x.numpy(), np.asarray(jax_x).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size,n", [(32, 3), (64, 2)])
def test_classification_task_matches_jax(monkeypatch, size, n):
    rng = np.random.default_rng(size)
    f32 = np.float32
    templates = rng.normal(size=(NUM_CLASSES, size // 8, size // 8, 3)).astype(f32)
    draws = {"labels": rng.integers(0, NUM_CLASSES, size=(n,)).astype(np.int32),
             "coarse": rng.normal(size=(n, size // 8, size // 8, 3)).astype(f32),
             "fine": rng.normal(size=(n, size, size, 3)).astype(f32)}
    fake = Draws(monkeypatch)
    fake.queue = [templates]
    batch = JAX_QA.make_task(None, NUM_CLASSES, size)
    fake.queue = [draws["labels"], draws["coarse"], draws["fine"]]
    jx, jy = batch(None, n)
    assert not fake.queue
    x, y = qa.classification_images(qa.upsample(_t(templates), size), {k: _t(v) for k, v in draws.items()})
    _assert_images(x, jx)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def _blob_draws(rng, n, size, classes, centre, extent, active_p):
    f32 = np.float32
    per_image = []
    for _ in range(n):
        image = [rng.normal(size=(size, size, 3)).astype(f32)]
        for _ in range(3):
            image += [np.asarray(rng.integers(*classes), np.int32), rng.uniform(*centre, size=2).astype(f32),
                      rng.uniform(*extent, size=2).astype(f32), np.asarray(rng.uniform(0, active_p), f32),
                      rng.normal(size=(size, size, 3)).astype(f32)]
        per_image.append(image)
    queue = [a for image in per_image for a in image]
    stacked = {
        "background": np.stack([im[0] for im in per_image]),
        "classes": np.stack([[im[1 + 5 * i] for i in range(3)] for im in per_image]).astype(np.int64),
        "centres": np.stack([[im[2 + 5 * i] for i in range(3)] for im in per_image]),
        "extents": np.stack([[im[3 + 5 * i] for i in range(3)] for im in per_image]),
        "active": np.stack([[im[4 + 5 * i] for i in range(3)] for im in per_image]),
        "fill": np.stack([[im[5 + 5 * i] for i in range(3)] for im in per_image]),
    }
    return queue, {k: _t(v) for k, v in stacked.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_segmentation_task_matches_jax(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    n, size = 3, 32
    sig = rng.normal(size=(NUM_CLASSES, 3)).astype(np.float32)
    queue, draws = _blob_draws(rng, n, size, (1, NUM_CLASSES), (0.2, 0.8), (0.08, 0.25), 1.2)
    draws["radii"] = draws.pop("extents")
    fake = Draws(monkeypatch)
    fake.queue = [sig]
    batch = JAX_QA.make_seg_task(None, NUM_CLASSES, size)
    fake.queue = queue
    jx, jmask = batch(None, n)
    assert not fake.queue
    x, mask = qa.segmentation_images(_t(sig) * 1.2, draws)
    _assert_images(x, jx)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert len(np.unique(mask.numpy())) > 2  # blobs drawn, some overwritten or inactive


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_task_matches_jax(monkeypatch, seed):
    rng = np.random.default_rng(10 + seed)
    n, size = 3, 32
    sig = rng.normal(size=(NUM_CLASSES, 3)).astype(np.float32)
    queue, draws = _blob_draws(rng, n, size, (0, NUM_CLASSES), (0.25, 0.75), (0.12, 0.3), 1.0)
    fake = Draws(monkeypatch)
    fake.queue = [sig]
    batch = JAX_QA.make_det_task(None, NUM_CLASSES, size)
    fake.queue = queue
    jx, jt = batch(None, n)
    assert not fake.queue
    x, target = qa.detection_images(_t(sig) * 1.2, draws)
    _assert_images(x, jx)
    for key in ("boxes", "labels", "mask"):
        np.testing.assert_array_equal(target[key].numpy(), np.asarray(jt[key]), err_msg=key)
    assert 0 < target["mask"].sum() < n * 3


def test_port_tasks_draw_from_the_generator():
    """The same seed gives the same batch; images standardized per image."""
    for make in (qa.make_task, qa.make_seg_task, qa.make_det_task):
        a = make(torch.Generator().manual_seed(7), NUM_CLASSES, 32)(torch.Generator().manual_seed(1), 2)
        b = make(torch.Generator().manual_seed(7), NUM_CLASSES, 32)(torch.Generator().manual_seed(1), 2)
        assert torch.equal(a[0], b[0]) and a[0].shape == (2, 3, 32, 32) and torch.isfinite(a[0]).all()
    x, y = qa.make_task(torch.Generator().manual_seed(7), NUM_CLASSES, 32)(torch.Generator().manual_seed(1), 2)
    torch.testing.assert_close(x.mean(dim=(1, 2, 3)), torch.zeros(2), atol=1e-5, rtol=0)


def _batches(n, seed, nan_at=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
        if i in nan_at:
            x[0, 0, 0, 0] = np.nan
        out.append((x, rng.integers(0, NUM_CLASSES, size=(BATCH,)).astype(np.int32)))
    return out


def _both_trained(batches):
    """Trains the JAX model through the script's ``train`` and the port's on ``batches``;
    returns both final states as the port's state dicts, the losses, and the start."""
    jm = Model(JaxRepVGG(*CFG, num_classes=NUM_CLASSES)).init((BATCH, SIZE, SIZE, 3), key=jax.random.key(0))
    start = convert.repvgg_state_dict(jax.tree.map(np.asarray, jm.variables))
    pm = RepVGG(*CFG, num_classes=NUM_CLASSES, device="cpu")
    pm.load_state_dict(start)
    jit = iter(batches)
    jloss = JAX_QA.train(jm, lambda key, n: next(jit), len(batches), BATCH)
    pit = iter([(_t(x.transpose(0, 3, 1, 2)), _t(y).long()) for x, y in batches])
    ploss = qa.train(pm, lambda gen, n: next(pit), len(batches), BATCH)
    theirs = convert.repvgg_state_dict(jax.tree.map(np.asarray, jm.variables))
    ours = {k: v.detach() for k, v in pm.state_dict().items() if "num_batches" not in k}
    return theirs, ours, (jloss, ploss), start


def _params(model_state, names):
    return {k: model_state[k] for k in names}


def test_train_matches_jax():
    """Three Adam steps on the same batches: the parameters and the final loss."""
    theirs, ours, (jloss, ploss), start = _both_trained(_batches(3, 0))
    names = [k for k in ours if "running" not in k]
    for k in names:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
        assert not torch.equal(ours[k], start[k]), k
    assert math.isclose(ploss, jloss, rel_tol=1e-4)


def test_a_non_finite_batch_is_skipped_in_both():
    """good, good, NaN: the NaN step moves no parameter in either (the two finite steps
    match, every parameter finite), its forward left NaN in the BN statistics of both,
    and both report the last finite loss. (The NaN batch comes last: the JAX package's
    BatchNorm2d shifts its train-mode statistics by the running mean,
    ``models/layers.py:80-92``, so in JAX every later step would be NaN too.)"""
    theirs, ours, (jloss, ploss), start = _both_trained(_batches(3, 1, nan_at=(2,)))
    for k in ours:
        if "running" in k:
            assert torch.isnan(ours[k]).any() and np.isnan(theirs[k].numpy()).any(), k
        else:
            assert torch.isfinite(ours[k]).all(), k
            np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    assert math.isfinite(jloss) and math.isclose(ploss, jloss, rel_tol=1e-4)


@pytest.mark.parametrize("steps", [qa.MAX_CONSECUTIVE_ERRORS, qa.MAX_CONSECUTIVE_ERRORS + 1])
def test_the_51st_consecutive_error_is_applied_in_both(steps):
    """50 non-finite steps in a row leave the parameters as they were in both; the 51st
    is applied in both, the head's gradient NaN in both, so the head is NaN in both; the
    reported loss is NaN in both. (Which earlier parameters take a NaN differs: the
    gradient of JAX's ReLU at a NaN input is 0, torch's passes the NaN on.)"""
    theirs, ours, losses, start = _both_trained(_batches(steps, 2, nan_at=range(steps)))
    assert all(math.isnan(v) for v in losses)
    params = [k for k in ours if "running" not in k]
    if steps == qa.MAX_CONSECUTIVE_ERRORS:
        for k in params:
            assert torch.equal(ours[k], start[k]) and np.array_equal(theirs[k].numpy(), start[k].numpy()), k
    else:
        for k in ("head.weight", "head.bias"):
            assert torch.isnan(ours[k]).all() and np.isnan(theirs[k].numpy()).all(), k


def _raw_outputs(rng, batches, batch, k, classes, objectness):
    out = []
    for _ in range(batches):
        xy = rng.uniform(0, 0.7, size=(batch, k, 2))
        wh = rng.uniform(0.05, 0.3, size=(batch, k, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        b_o = (rng.uniform(size=(batch, k)) * objectness).astype(np.float32)
        logits = rng.normal(size=(batch, k, classes)) * 3
        b_scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
        out.append((boxes, b_o, b_scores))
    return out


@pytest.mark.parametrize("objectness", [1.0, 0.02])
def test_measure_detection_matches_jax(objectness):
    """The same cached raw outputs of both forms (int8 a perturbed bf16) and the same
    targets: at objectness up to 1 the first rung, at 0.02 the rank rung."""
    rng = np.random.default_rng(3)
    batches, batch, k = 2, 3, 40
    raw_ref = _raw_outputs(rng, batches, batch, k, NUM_CLASSES, objectness)
    raw_q = [(b + rng.normal(scale=0.01, size=b.shape).astype(np.float32), o, s) for b, o, s in raw_ref]
    targets = []
    for _ in range(batches):
        tgt = {"boxes": rng.uniform(0, 1, size=(batch, 8, 4)).astype(np.float32),
               "labels": rng.integers(0, NUM_CLASSES, size=(batch, 8)).astype(np.int32),
               "mask": rng.uniform(size=(batch, 8)) < 0.4}
        tgt["boxes"][..., 2:] = tgt["boxes"][..., :2] + 0.2
        targets.append((rng.normal(size=(batch, 8, 8, 3)).astype(np.float32), tgt))

    def served(items, convert_fn):
        it = iter(items)
        return lambda *args: convert_fn(next(it))

    jrow = JAX_QA._measure_detection(
        SimpleNamespace(module=SimpleNamespace(rpn_nms_thresh=0.5, box_score_thresh=0.05)),
        served(raw_ref, tuple), served(raw_q, tuple), served(targets, lambda t: t), jax.random.key(0), batches, batch)
    prow = qa.measure_detection(
        SimpleNamespace(rpn_nms_thresh=0.5, box_score_thresh=0.05),
        served(raw_ref, lambda r: tuple(_t(a) for a in r)), served(raw_q, lambda r: tuple(_t(a) for a in r)),
        served(targets, lambda t: (_t(t[0]), {key: _t(v) for key, v in t[1].items()})),
        torch.Generator(), batches, batch)
    assert prow.keys() == jrow.keys()
    for key, value in jrow.items():
        assert math.isclose(prow[key], value, rel_tol=1e-6, abs_tol=1e-6), (key, prow[key], value)
    assert (prow["obj_thresh"] == 0.5) == (objectness == 1.0)
    assert prow["dets_per_image_bf16"] > 0


def test_evaluate_and_evaluate_dense_match_jax():
    rng = np.random.default_rng(4)
    cls = [(rng.normal(size=(5, 8, 8, 3)).astype(np.float32), rng.integers(0, 3, size=(5,)).astype(np.int32))
           for _ in range(2)]
    dense = [(rng.normal(size=(2, 8, 8, 3)).astype(np.float32), rng.integers(0, 3, size=(2, 8, 8)).astype(np.int32))
             for _ in range(2)]
    w = rng.normal(size=(3, 3)).astype(np.float32)

    def served(items):
        it = iter(items)
        return lambda *args: next(it)

    jcls = JAX_QA.evaluate(lambda x: jnp.asarray(x).mean((1, 2)) @ w, served(cls), jax.random.key(0), 2, 5)
    pcls = qa.evaluate(lambda x: x.mean((2, 3)) @ _t(w), served([(_t(x.transpose(0, 3, 1, 2)), _t(y))
                                                                   for x, y in cls]), None, 2, 5)
    jden = JAX_QA.evaluate_dense(lambda x: jnp.asarray(x) @ w, served(dense), jax.random.key(0), 2, 2)
    pden = qa.evaluate_dense(lambda x: torch.einsum("nchw,ck->nkhw", x, _t(w)),
                             served([(_t(x.transpose(0, 3, 1, 2)), _t(y)) for x, y in dense]), None, 2, 2)
    assert (pcls, pden) == (jcls, jden) and 0 < pden < 1


@pytest.mark.parametrize("arch", ["repvgg_a0", "convnext_tiny", "unet3p", "unet_rexnet13", "yolov1", "yolov4"])
def test_infer_task_matches_jax(arch):
    assert qa.infer_task(arch) == JAX_QA.infer_task(arch)


def test_main_on_the_cpu_writes_every_key(tmp_path):
    """A tiny sweep on the CPU: one classification row with the JAX script's keys plus
    device, steps and seconds, appended to --out; the CLI refuses the card where there is
    none."""
    out = tmp_path / "rows.jsonl"
    rows = qa.main(qa.parse_args(["--archs", "repvgg_a0", "--device", "cpu", "--steps", "2", "--batch", "4",
                                  "--size", "32", "--eval-batches", "1", "--out", str(out)]))
    assert set(rows[0]) == {"arch", "task", "weights", "acc_bf16", "acc_int8", "top1_agreement", "max_prob_drift",
                            "device", "steps", "seconds"}
    assert rows[0]["device"] == "cpu" and rows[0]["weights"].startswith("trained 2 steps")
    assert len(out.read_text().splitlines()) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qa.main(qa.parse_args(["--archs", "repvgg_a0"]))


# --- the gate's forms on the same weights (scripts/quant_accuracy.py:340-349) ---

# Tolerance of a reference form's raw outputs against JAX's, as a fraction of their
# largest magnitude: both compute float32 over the same bf16-rounded weights (and sum
# BN's variance and epsilon in bf16), in another order.
FORMS_RTOL = 1e-4
GATE_CFG = ([1, 2], [16, 64], 1.0, 1.0)  # two 64-channel convs: int8 under repvgg_a0's min_in_channels 48


def _jax_forms(jm, calib, arch):
    """The script's two forms: the bf16 variables applied to float32 images, and the
    int8 form quantized from the float32 model, then given the bf16 variables."""
    bf16_vars = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jm.variables)
    module = jm.module
    ref = jax.jit(lambda v, a: module.apply(v, a, train=False))
    qm = jquant.quantize_model(jm, calibration_batches=calib, arch=arch)
    qm.variables = bf16_vars
    qfwd, qparams = jax.jit(qm.apply_fn()), qm.qparams
    return (lambda a: ref(bf16_vars, a)), (lambda a: qfwd(qm.variables, qparams, a)), qm


def _max_rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-12))


def _jax_conv_dtypes(fn, x) -> list:
    """The (input, kernel, output) dtypes of every conv in ``fn``'s jaxpr at ``x``,
    nested jaxprs included."""
    from jax.extend import core as jcore

    seen = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "conv_general_dilated":
                seen.append(tuple(str(v.aval.dtype) for v in (*eqn.invars, *eqn.outvars)))
            for value in eqn.params.values():
                for sub in value if isinstance(value, (tuple, list)) else (value,):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(x).jaxpr)
    return seen


def _conv_dtypes(model, fwd, x) -> set:
    """The (input, output) dtypes of every conv call of ``fwd(x)`` in ``model``."""
    seen = set()
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.add((args[0].dtype, out.dtype)))
             for m in model.modules() if isinstance(m, (quant.QuantizedConv2d, torch.nn.Conv2d))]
    try:
        with torch.no_grad():
            fwd(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.fixture(scope="module")
def classifier_forms():
    """A small RepVGG, BN drawn away from the identity, reparametrized by JAX; the port
    gets its deploy weights. Both packages' forms, calibrated on the same 2 batches."""
    rng = np.random.default_rng(5)
    calib = [rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    x = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    jm = Model(JaxRepVGG(*GATE_CFG, num_classes=NUM_CLASSES)).init(x.shape, key=jax.random.key(0))
    jm.load_variables(jax.tree.map(jnp.asarray, randomize_bn(jm.variables, rng)))
    jm.reparametrize()
    pm = RepVGG(*GATE_CFG, num_classes=NUM_CLASSES, device="cpu").reparametrize()
    pm.load_state_dict(convert.repvgg_state_dict(jax.tree.map(np.asarray, jm.variables)))
    pm.eval()
    jref, jint8, jq = _jax_forms(jm, [jnp.asarray(c) for c in calib], "repvgg_a0")
    ref, qm = qa.gate_forms(pm, [_nchw(c) for c in calib], "repvgg_a0")
    return {"x": x, "pm": pm, "jref": jref, "jint8": jint8, "jq": jq, "ref": ref, "qm": qm, "fwd": lambda m: m}


@pytest.fixture(scope="module")
def detector_forms():
    """YOLOv4 at the detector parity tests' size (64 px, narrow): its convs drawn
    He-normal, BN and its prediction convs drawn as there (``jax.jit(module.init)`` would
    take 20 s to compile); the port's detection task, whose images and boxes are the JAX
    script's arithmetic, served by seed to both packages. Both packages' forms,
    calibrated on the batches of seeds 1000 and 1001."""
    from test_torch_detection import ARCHS

    make_jax, make_port = ARCHS["yolov4"]
    module, size, batch = make_jax(), 64, 4
    task = qa.make_det_task(torch.Generator().manual_seed(7), NUM_CLASSES, size)
    served = {seed: [task(torch.Generator().manual_seed(seed), batch) for _ in range(n)]
              for seed, n in ((1000, 1), (1001, 1), (2000, 2))}
    calib = [served[seed][0][0] for seed in (1000, 1001)]
    rng = np.random.default_rng(0)

    def drawn(path, leaf):
        if path[-1].key != "kernel":
            return np.zeros(leaf.shape, np.float32)  # BN's, drawn below
        return rng.normal(0, np.sqrt(2.0 / np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(module.init, jax.random.key(0), _nhwc(calib[0]))
    variables = randomize_bn(jax.tree_util.tree_map_with_path(drawn, shapes), rng)
    for name in ("head1_1", "head2_2_1", "head3_6"):
        node = variables["params"]["head"][name]
        node["kernel"] = rng.normal(0, 0.1, node["kernel"].shape).astype(np.float32)
        node["bias"] = rng.normal(0, 0.1, node["bias"].shape).astype(np.float32)
    jm = JaxDetectionModel(module, jax.tree.map(jnp.asarray, variables))
    pm = make_port().eval()
    pm.load_state_dict(convert.detection_state_dict(variables, pm))
    jref, jint8, jq = _jax_forms(jm, [jnp.asarray(_nhwc(c)) for c in calib], "yolov4")
    ref, qm = qa.gate_forms(pm, calib, "yolov4")
    return {"x": _nhwc(calib[1]), "pm": pm, "jm": jm, "jref": jref, "jint8": jint8, "jq": jq, "ref": ref, "qm": qm,
            "fwd": lambda m: m.raw, "served": served, "batch": batch}


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _outputs(out):
    return [o.float().numpy() for o in out] if isinstance(out, (tuple, list)) else [out.float().numpy()]


def _jax_outputs(out):
    return [np.asarray(o) for o in out] if isinstance(out, (tuple, list)) else [np.asarray(out)]


@pytest.mark.parametrize("forms", ["classifier_forms", "detector_forms"])
def test_reference_form_matches_the_jax_script(request, forms):
    """The reference ("bf16") form against JAX's ``module.apply(bf16_vars, x)`` on float32
    images, whose every conv runs in float32: every raw output within FORMS_RTOL of its
    largest magnitude. The parent's form (model and images cast to bf16) misses that
    tolerance on the same check."""
    f = request.getfixturevalue(forms)
    x = _nchw(f["x"])
    convs = _jax_conv_dtypes(f["jref"], jnp.asarray(f["x"]))
    assert convs and set(convs) == {("float32",) * 3}
    theirs = _jax_outputs(f["jref"](jnp.asarray(f["x"])))
    with torch.no_grad():
        out = f["fwd"](f["ref"])(x)
        assert all(o.dtype == torch.float32 for o in (out if isinstance(out, tuple) else [out]))
        ours = _outputs(out)
        bf16 = copy.deepcopy(f["pm"]).to(torch.bfloat16)
        parent = _outputs(f["fwd"](bf16)(x.to(torch.bfloat16)))
    errors = [_max_rel_err(o, t) for o, t in zip(ours, theirs)]
    parent_errors = [_max_rel_err(o, t) for o, t in zip(parent, theirs)]
    assert max(errors) <= FORMS_RTOL, errors
    assert max(parent_errors) > FORMS_RTOL, parent_errors


@pytest.mark.parametrize("forms", ["classifier_forms", "detector_forms"])
def test_int8_form_is_float32_over_the_jax_qparams(request, forms):
    """Every conv of the int8 form takes and returns float32, as in JAX's int8 form (its
    int8 convs accumulate in int32, the others run in float32); its int8 layers are
    JAX's ``qparams`` (the same kernels and weight scales, the activation scales within
    1e-5) and their biases JAX's bf16 variables; the float remainder is rounded through
    bf16, the scales are not."""
    f = request.getfixturevalue(forms)
    qm, jq = f["qm"], f["jq"]
    convs = _jax_conv_dtypes(f["jint8"], jnp.asarray(f["x"]))
    assert convs.count(("int8", "int8", "int32")) == len(jq.qparams)
    assert set(convs) == {("int8", "int8", "int32"), ("float32",) * 3}
    assert _conv_dtypes(qm, f["fwd"](qm), _nchw(f["x"])) == {(torch.float32, torch.float32)}
    layers = [m for m in qm.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert layers and len(layers) == len(jq.qparams)
    ours = sorted((m.kernel_q.numpy().tobytes(), m.w_scale.numpy().tobytes(), float(m.act_scale),
                   b"" if m.bias is None else m.bias.detach().numpy().tobytes()) for m in layers)
    bias = {}

    def visit(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v, f"{path}/{k}" if path else k)
            elif k == "bias":
                bias[path] = np.asarray(v, np.float32)

    visit(jq.variables["params"], "")
    theirs = sorted((np.asarray(q["kernel_q"]).tobytes(), np.asarray(q["w_scale"]).tobytes(),
                     max(jq.act_scales[k], 1e-12) / quant.QINT_MAX, bias[k].tobytes() if k in bias else b"")
                    for k, q in jq.qparams.items())
    assert [(k, w, b) for k, w, _, b in ours] == [(k, w, b) for k, w, _, b in theirs]
    np.testing.assert_allclose([s for _, _, s, _ in ours], [s for _, _, s, _ in theirs], rtol=1e-5)
    for name, t in qm.state_dict().items():
        if name.endswith("running_var"):  # var + eps is the bf16 sum, to float32 rounding
            torch.testing.assert_close(t + 1e-5, (t + 1e-5).to(torch.bfloat16).float(), rtol=1e-6, atol=0)
        elif t.is_floating_point() and not name.endswith(("w_scale", "act_scale")):
            assert torch.equal(t, t.to(torch.bfloat16).float()), name
    assert any(not torch.equal(m.w_scale, m.w_scale.to(torch.bfloat16).float()) for m in layers)


def test_int8_classifier_logits_match_jax(classifier_forms):
    """The int8 forms' logits on the same images: within 1e-3, the same top-1."""
    f = classifier_forms
    expected = np.asarray(f["jint8"](jnp.asarray(f["x"])))
    with torch.no_grad():
        out = f["qm"](_nchw(f["x"])).numpy()
    np.testing.assert_allclose(out, expected, atol=1e-3)
    np.testing.assert_array_equal(out.argmax(-1), expected.argmax(-1))


def test_exact_float32_turns_tf32_off_and_restores_it():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        with qa.exact_float32():
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
        with pytest.raises(RuntimeError), qa.exact_float32():
            raise RuntimeError("restored on an error too")
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


# det_f1 of the two packages' gates on the same weights and images: the forms agree to
# float32 rounding, and the int8 forms to an activation's rounding step now and then
GATE_F1_TOL = 0.02


def test_detector_gate_matches_jax(detector_forms):
    """One detector's whole gate on the same weights and the same images: the JAX
    script's ``_measure_detection`` over its forms, and the port's ``measure_trained``
    (its forms, ladder and box-F1), the batches served by seed (calibration 1000-1001,
    evaluation 2000): the same rung and detections an image within 5%, ``det_f1``
    within GATE_F1_TOL."""
    f = detector_forms
    served, batch = f["served"], f["batch"]
    evaluation = iter(served[2000])

    def jax_batch(key, n):
        x, tgt = next(evaluation)
        return jnp.asarray(_nhwc(x)), {k: v.numpy() for k, v in tgt.items()}

    jrow = JAX_QA._measure_detection(f["jm"], f["jref"], f["jint8"], jax_batch, jax.random.key(2000), len(served[2000]),
                                     batch)
    prow = qa.measure_trained(f["pm"], "yolov4", "detection", lambda it, n: next(it), lambda seed: iter(served[seed]),
                              len(served[2000]), batch)
    assert prow.keys() == jrow.keys()
    assert (prow["obj_thresh"], prow["score_thresh"] == pytest.approx(jrow["score_thresh"], rel=1e-4)) == (
        jrow["obj_thresh"], True), (prow, jrow)
    assert prow["dets_per_image_bf16"] == pytest.approx(jrow["dets_per_image_bf16"], rel=0.05)
    assert prow["dets_per_image_bf16"] >= 0.5
    assert abs(prow["det_f1"] - jrow["det_f1"]) <= GATE_F1_TOL, (prow, jrow)
