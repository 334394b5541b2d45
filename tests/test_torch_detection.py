"""Parity of the PyTorch port's detection path with the JAX package, on the CPU in
float32: YOLOv1, YOLOv2 and YOLOv4 (raw outputs, loss dicts and their gradients with
padded and empty ground truth), the static-shape post-processing (``pad_targets``,
``box_iou_pairwise``, ``masked_nms``, ``post_process``, ``detections_to_list``, ties
included), the detection int8 gate, and the JAX package's own detection cases.

One JAX detector an architecture, narrow and shallow, at 64 px, built once for the
module (the JAX side compiles slowly on the CPU); BN randomized from a numpy seed and
YOLOv4's zero-initialized prediction convs drawn at random, so that every output
depends on every layer. ``holocron_tpu_torch.convert.detection_state_dict`` carries the
weights across. Ground truth comes from ``tests/test_models_detection.py``'s
``_make_targets``.

Tolerances (float32): raw outputs within 1e-4 of their largest magnitude plus 1e-4
relative; each loss within 1e-5 relative; each parameter's gradient within 1e-4 of its
tensor's largest magnitude plus 1e-3 relative (``test_torch_resnet.py``'s); keep masks
and detection lists identical; each int8 conv's output within 1e-5 of its largest magnitude on the
same input.
"""

import importlib
import urllib.request

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models_detection import _make_targets
from test_torch_resnet import _close, nchw, randomize_bn

from holocron_tpu import quant as jquant
from holocron_tpu.models.detection import _utils as jutils
from holocron_tpu.models.detection.yolo import DetectionModel as JaxDetectionModel
from holocron_tpu_torch import convert, quant
from holocron_tpu_torch.models import detection
from holocron_tpu_torch.models.detection import _utils as putils
from holocron_tpu_torch.models.detection.yolo import yolo_v12_losses
from holocron_tpu_torch.models.layers import FrozenBatchNorm2d

torch.set_num_threads(2)

jyolo = {name: importlib.import_module(f"holocron_tpu.models.detection.{name}")
         for name in ("yolo", "yolov2", "yolov4")}

NUM_CLASSES = 3
SIZE = 64
MAX_BOXES = 10
V1_LAYOUT = [[16], [16, 32]]
V2_LAYOUT = [(8, 0), (16, 1), (16, 0), (32, 1), (32, 1)]
V4_LAYOUT = [(8, 1), (16, 2), (16, 1), (32, 1), (32, 1)]

ARCHS = {
    "yolov1": (lambda: jyolo["yolo"].YOLOv1(V1_LAYOUT, num_classes=NUM_CLASSES),
               lambda: detection.YOLOv1(V1_LAYOUT, num_classes=NUM_CLASSES, input_shape=(3, SIZE, SIZE), device="cpu")),
    "yolov2": (lambda: jyolo["yolov2"].YOLOv2(V2_LAYOUT, num_classes=NUM_CLASSES),
               lambda: detection.YOLOv2(V2_LAYOUT, num_classes=NUM_CLASSES, device="cpu")),
    # the default DropBlock: the identity in eval, as in JAX with train=False
    "yolov4": (lambda: jyolo["yolov4"].YOLOv4(V4_LAYOUT, num_classes=NUM_CLASSES),
               lambda: detection.YOLOv4(V4_LAYOUT, num_classes=NUM_CLASSES, device="cpu")),
}


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """No network: fetching a release URL fails as it does offline, into an empty cache."""
    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("HOLOCRON_CACHE_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=list(ARCHS))
def detector(request, x):
    make_jax, make_port = ARCHS[request.param]
    module = make_jax()
    rng = np.random.default_rng(0)
    variables = jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.key(0), x))
    if "batch_stats" in variables:
        variables = randomize_bn(variables, rng)
    if request.param == "yolov4":
        for name in ("head1_1", "head2_2_1", "head3_6"):
            node = variables["params"]["head"][name]
            node["kernel"] = rng.normal(0, 0.1, node["kernel"].shape).astype(np.float32)
            node["bias"] = rng.normal(0, 0.1, node["bias"].shape).astype(np.float32)
    pm = make_port().eval()
    sd = convert.detection_state_dict(variables, pm)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    return request.param, module, variables, pm


def _targets(kind: str):
    """The same ground truth padded by each package: two images of 3 and 4 boxes, or
    two with none."""
    gts = _make_targets([3, 4], NUM_CLASSES) if kind == "boxes" else [
        {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int64)} for _ in range(2)]
    return jax.tree.map(jnp.asarray, dict(jutils.pad_targets(gts, MAX_BOXES))), putils.pad_targets(gts, MAX_BOXES)


def test_detector_raw_matches_jax(detector, x):
    """The raw eval outputs (boxes, objectness, class probabilities)."""
    _, module, variables, pm = detector
    refs = jax.jit(module.apply)(variables, x)
    with torch.no_grad():
        outs = pm.raw(nchw(x))
    for name, out, ref in zip(("boxes", "b_o", "b_scores"), outs, refs):
        assert tuple(out.shape) == tuple(ref.shape)
        _close(out.numpy(), ref, 1e-4, name, rtol=1e-4)


def test_detector_losses_and_grads_match_jax(detector, x):
    """The eval-mode loss dict (the JAX ``DetectionModel(x, target)``) and every
    parameter's gradient of its sum, with padded ground truth and with none: finite and
    equal."""
    arch, module, variables, pm = detector
    stats = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params, target):
        losses = module.apply({"params": params, **stats}, x, target, train=False)
        return sum(losses.values()), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for kind in ("boxes", "empty"):
        jtarget, ptarget = _targets(kind)
        (_, ref_losses), ref_grads = grad_fn(variables["params"], jtarget)
        pm.zero_grad()
        losses = pm(nchw(x), ptarget)
        sum(losses.values()).backward()
        assert set(losses) == set(ref_losses) == {"obj_loss", "noobj_loss", "bbox_loss", "clf_loss"}
        for name, value in losses.items():
            assert torch.isfinite(value)
            np.testing.assert_allclose(float(value.detach()), float(ref_losses[name]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{arch} {kind} {name}")
        expected = convert.detection_state_dict({"params": jax.tree.map(np.asarray, ref_grads), **stats}, pm)
        for name, p in pm.named_parameters():
            assert bool(torch.isfinite(p.grad).all()), f"{arch} {kind} grad {name}"
            _close(p.grad.numpy(), expected[name].numpy(), 1e-4, f"{arch} {kind} grad {name}", rtol=1e-3)
        if kind == "boxes":
            assert max(float(p.grad.abs().max()) for p in pm.parameters()) > 0


def test_int8_detector_matches_jax(detector, x):
    """The selective-int8 form (every conv of 8 input channels or more, per-call
    activation scales) against the JAX package's on the same weights: the same convs
    selected, the prediction convs among them, and each int8 conv, fed the input its
    JAX counterpart saw in the JAX int8 forward, within 1e-5 of that layer's output
    (the int8 arithmetic is exact; the epilogue rounds). The whole forwards are not
    compared: a 1e-7 difference in a float layer (Mish, BN) flips an activation across
    a rounding step of the next int8 conv now and then, which deeper layers amplify.
    The eval forward returns detections; post-processing stays float32."""
    arch, module, variables, pm = detector
    jq = jquant.quantize_model(JaxDetectionModel(module, variables), min_in_channels=8, input_shape=x.shape)
    pq = quant.quantize_model(pm, min_in_channels=8)
    layers = [m for m in pq.modules() if isinstance(m, quant.QuantizedConv2d)]
    assert len(layers) == len(jq.qparams)
    assert {m.kernel_q.numpy().tobytes() for m in layers} == {np.asarray(q["kernel_q"]).tobytes()
                                                              for q in jq.qparams.values()}
    if arch == "yolov4":  # the three prediction convs, (5 + C) * 3 wide
        assert sum(m.kernel_q.shape[3] == 3 * (5 + NUM_CLASSES) for m in layers) == 3
    fwd = jq.apply_fn()

    paths = []  # filled while tracing

    def recorded(variables, qparams, inp):
        seen = []

        def record(next_fn, args, kwargs, context):
            out = next_fn(*args, **kwargs)
            if isinstance(context.module, flax_nn.Conv) and context.method_name == "__call__":
                paths.append("/".join(context.module.path))
                seen.append((args[0], out))
            return out

        with flax_nn.intercept_methods(record):
            fwd(variables, qparams, inp)
        return seen

    seen = [(path, *pair) for path, pair in zip(paths, jax.jit(recorded)(jq.variables, jq.qparams, jnp.asarray(x)))]
    order = []
    hooks = [m.register_forward_pre_hook(lambda mod, _args: order.append(mod)) for m in pq.modules()
             if isinstance(m, (quant.QuantizedConv2d, torch.nn.Conv2d))]
    try:
        with torch.no_grad():
            dets = pq(nchw(x))
    finally:
        for h in hooks:
            h.remove()
    assert len(order) == len(seen)
    checked = 0
    with torch.no_grad():
        for mod, (path, inp, ref) in zip(order, seen):
            if not isinstance(mod, quant.QuantizedConv2d):
                continue
            out = mod(nchw(np.asarray(inp)))
            _close(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), 1e-5, f"{arch} int8 {path}")
            checked += 1
    assert checked == len(layers)
    assert len(dets) == 2 and all(d["scores"].dtype == np.float32 for d in dets)


@pytest.mark.parametrize("arch", ["yolov1", "yolov2", "yolov4"])
def test_detection_model_contract(arch, offline):
    """``tests/test_models_detection.py:29-66`` on the port at full width (64 px, 10
    classes): eval detections as lists of numpy dicts, a list of images, train mode
    without a target, finite losses with boxes and with none, out-of-range boxes; and
    the factories' flags offline: ``pretrained=True`` keeps the drawn weights,
    ``pretrained_backbone=True`` freezes the backbone's BN (v2, v4) and, with no file
    to load, keeps the drawn backbone."""
    num_classes = 10
    kwargs = {"input_shape": (3, 64, 64)} if arch == "yolov1" else {}
    gen = torch.Generator().manual_seed(0)
    model = getattr(detection, arch)(pretrained_backbone=False, num_classes=num_classes, device="cpu",
                                     generator=gen, **kwargs).eval()
    x = torch.rand(2, 3, 64, 64, generator=gen)
    with torch.no_grad():
        out = model(x)
        assert isinstance(out, list) and len(out) == 2
        assert all(isinstance(out[0][k], np.ndarray) for k in ("boxes", "scores", "labels"))
        assert len(model([x[0], x[1]])) == 2
        loss = model(x, _make_targets([3, 4], num_classes))
        assert isinstance(loss, dict) and all(bool(torch.isfinite(v)) for v in loss.values())
        empty = [{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int64)} for _ in range(2)]
        assert all(bool(torch.isfinite(v)) for v in model(x, empty).values())
        with pytest.raises(ValueError):
            model(x, [{"boxes": np.asarray([[0.0, 0.0, 2.0, 1.0]], np.float32), "labels": np.asarray([0])}])
        model.train()
        with pytest.raises(ValueError):
            model(x)
    assert not getattr(detection, arch)(pretrained=True, device="meta", **kwargs).pretrained_loaded
    frozen = getattr(detection, arch)(device="meta", **kwargs)
    assert not frozen.pretrained_loaded and frozen.default_cfg["url"] is None
    has_frozen = any(isinstance(m, FrozenBatchNorm2d) for m in frozen.backbone.modules())
    assert has_frozen == (arch != "yolov1")


@pytest.mark.parametrize("side", [72, 100])
def test_yolov1_grid_at_a_side_off_its_stride(side):
    """At an input side that is not a multiple of the layout's stride (16 here; 64 for
    darknet24, as yolov1 at 416 px), the head is sized for the feature map the convs and
    pools give (the stem and block4 round up, the pools down), as the JAX package's
    head, sized at init, has it: the same raw output shapes."""
    module = jyolo["yolo"].YOLOv1(V1_LAYOUT, num_classes=NUM_CLASSES)
    x = jnp.zeros((1, side, side, 3))
    refs = module.apply(module.init(jax.random.key(0), x), x)
    pm = detection.YOLOv1(V1_LAYOUT, num_classes=NUM_CLASSES, input_shape=(3, side, side), device="cpu").eval()
    with torch.no_grad():
        outs = pm.raw(torch.zeros(1, 3, side, side))
    assert [tuple(o.shape) for o in outs] == [tuple(r.shape) for r in refs]


def test_yolo_closed_form_losses():
    """``tests/test_models_detection.py``'s closed-form case on the port: crafted
    predictions, one box matched exactly."""
    h = w = 7
    num_anchors, num_classes = 2, 10
    xy_rel = np.full((1, h, w, num_anchors, 2), 0.5, np.float32)
    xy_rel[0, 0, 0, 1, 0] = 0.8
    wh = np.full((1, h, w, num_anchors, 2), 1 / 7, np.float32)
    c_x = np.arange(w, dtype=np.float32).reshape(1, 1, -1, 1)
    c_y = np.arange(h, dtype=np.float32).reshape(1, -1, 1, 1)
    xy = np.stack([(xy_rel[..., 0] + c_x) / w, (xy_rel[..., 1] + c_y) / h], axis=-1)
    pred_xyxy = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    pred_o = np.zeros((1, h, w, num_anchors), np.float32)
    pred_o[0, 0, 0, 0] = 0.5
    pred_o[0, -1, -1, 0] = 0.5
    pred_scores = np.zeros((1, h, w, 1, num_classes), np.float32)
    pred_scores[0, 0, 0, 0, 0] = 0.5
    pred_scores[0, 0, 0, 0, 1:] = 0.5 / (num_classes - 1)
    target = putils.pad_targets([{"boxes": np.asarray([[0, 0, 1 / 7, 1 / 7]], np.float32),
                                  "labels": np.asarray([0])}], 4)
    t = torch.from_numpy
    losses = yolo_v12_losses(t(pred_xyxy), t(xy), t(wh), t(pred_o), t(pred_scores), target, 1.0, 0.5, 1.0, 5.0,
                             ignore_high_iou=True)
    assert float(losses["obj_loss"]) == pytest.approx(0.5**2, abs=1e-6)
    assert float(losses["noobj_loss"]) == pytest.approx(0.5 * 0.5**2, abs=1e-6)
    assert float(losses["bbox_loss"]) == pytest.approx(0.0, abs=1e-6)
    assert float(losses["clf_loss"]) == pytest.approx(0.5**2 + (num_classes - 1) * (0.5 / (num_classes - 1)) ** 2,
                                                      abs=1e-6)


def test_yolo_loss_grads_finite_at_zero_wh():
    """The wh term's square root has a zero subgradient where a predicted wh is exactly
    0 (``tests/test_models_detection.py:92``), and the healthy gradient is unchanged."""
    h = w = 2
    num_anchors, num_classes = 2, 3
    target = putils.pad_targets([{"boxes": np.asarray([[0.1, 0.1, 0.4, 0.4]], np.float32),
                                  "labels": np.asarray([0])}], 4)

    def loss_of(wh_val):
        xy = torch.full((1, h, w, num_anchors, 2), 0.25, dtype=torch.float64)
        wh = torch.ones((1, h, w, num_anchors, 2), dtype=torch.float64) * wh_val
        pred_xyxy = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
        po = torch.full((1, h, w, num_anchors), 0.3, dtype=torch.float64)
        scores = torch.full((1, h, w, num_anchors, num_classes), 1.0 / num_classes, dtype=torch.float64)
        tgt = {**target, "boxes": target["boxes"].double()}
        return sum(yolo_v12_losses(pred_xyxy, xy, wh, po, scores, tgt).values())

    zero = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    loss_of(zero).backward()
    assert torch.isfinite(zero.grad)
    pos = torch.tensor(0.09, dtype=torch.float64, requires_grad=True)
    loss_of(pos).backward()
    ref = (float(loss_of(0.09 + 5e-4)) - float(loss_of(0.09 - 5e-4))) / 1e-3
    assert float(pos.grad) == pytest.approx(ref, rel=1e-2)


def test_post_process_obj_thresh():
    """``obj_thresh`` is the objectness gate (0.5 by default): lowering it admits the
    box below it."""
    boxes = torch.tensor([[[0.0, 0.0, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]])
    b_o = torch.tensor([[0.3, 0.6]])
    b_scores = torch.tensor([[[0.9, 0.1], [0.8, 0.2]]])
    assert int(putils.post_process(boxes, b_o, b_scores, 0.7, 0.05)["keep"].sum()) == 1
    assert int(putils.post_process(boxes, b_o, b_scores, 0.7, 0.05, obj_thresh=0.2)["keep"].sum()) == 2


def _raw_case(kind: str, rng, n: int = 60, num_classes: int = 4):
    """Raw outputs of one batch of 2: random overlapping boxes; ``ties``: every score
    one of three values and each box duplicated with a small shift (equal scores on
    overlapping boxes); ``invalid``: objectness all below the gate."""
    boxes = rng.random((2, n, 4), np.float32) * 0.7
    boxes[..., 2:] = boxes[..., :2] + rng.random((2, n, 2)).astype(np.float32) * 0.4 + 0.02
    b_o = rng.uniform(0.3, 1.0, (2, n)).astype(np.float32)
    b_scores = rng.dirichlet(np.ones(num_classes), (2, n)).astype(np.float32)
    if kind == "ties":
        b_o = np.full((2, n), 0.9, np.float32)
        b_scores = np.zeros((2, n, num_classes), np.float32)
        b_scores[..., 1] = rng.choice([0.5, 0.7, 0.9], (2, n)).astype(np.float32)
        boxes[:, 1::2] = boxes[:, 0::2] + 0.01
    elif kind == "invalid":
        b_o = b_o * 0.4
    return boxes, b_o, b_scores


@pytest.mark.parametrize("kind", ["random", "ties", "invalid"])
def test_post_process_matches_jax(kind):
    """The same raw arrays through both packages' ``post_process`` (the top 32 of 60
    candidates, NMS at 0.5): identical boxes, scores, labels and keep masks, and
    identical ``detections_to_list`` lists; ``masked_nms`` on each image too."""
    rng = np.random.default_rng({"random": 3, "ties": 4, "invalid": 5}[kind])
    boxes, b_o, b_scores = _raw_case(kind, rng)
    ref = jutils.post_process(jnp.asarray(boxes), jnp.asarray(b_o), jnp.asarray(b_scores), rpn_nms_thresh=0.5,
                              box_score_thresh=0.05, pre_nms_topk=32)
    got = putils.post_process(torch.from_numpy(boxes), torch.from_numpy(b_o), torch.from_numpy(b_scores), 0.5, 0.05,
                              pre_nms_topk=32)
    for key in ("boxes", "scores", "labels", "keep"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=f"{kind} {key}")
    kept = int(got["keep"].sum())
    assert (kept == 0) == (kind == "invalid")
    ours, theirs = putils.detections_to_list(got), jutils.detections_to_list(ref)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype
    for i in range(2):
        scores = b_scores[i].max(-1) * b_o[i]
        valid = b_o[i] >= 0.5
        keep = putils.masked_nms(torch.from_numpy(boxes[i]), torch.from_numpy(scores), torch.from_numpy(valid), 0.5)
        want = jutils.masked_nms(jnp.asarray(boxes[i]), jnp.asarray(scores), jnp.asarray(valid), 0.5)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want))


def test_box_iou_and_pad_targets_match_jax():
    """``box_iou_pairwise`` on batched random boxes (touching and disjoint ones among
    them) and ``pad_targets`` of ragged ground truth, more boxes than slots included."""
    rng = np.random.default_rng(6)
    a = rng.random((2, 7, 4), np.float32)
    a[..., 2:] += a[..., :2]
    b = rng.random((2, 5, 4), np.float32)
    b[..., 2:] += b[..., :2]
    b[0, 0] = [a[0, 0, 2], a[0, 0, 1], a[0, 0, 2] + 0.1, a[0, 0, 3]]  # touches a[0, 0]
    np.testing.assert_allclose(putils.box_iou_pairwise(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jutils.box_iou_pairwise(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-7)
    gts = _make_targets([3, 1, 12], 5)
    ours, theirs = putils.pad_targets(gts, 10), jutils.pad_targets(gts, 10)
    for key in ("boxes", "labels", "mask"):
        np.testing.assert_array_equal(ours[key].numpy(), theirs[key])


def test_measure_agreement_detection_matches_jax():
    """The box-F1 gate of both packages on the same detection lists: a perturbed copy
    (dropped, shifted and relabeled boxes, an empty image), and the vacuous case of no
    detections on either side."""
    rng = np.random.default_rng(7)
    ref_batches, q_batches = [], []
    for _ in range(2):
        ref, q = [], []
        for n in (6, 0, 4):
            boxes = rng.random((n, 4)).astype(np.float32) * 0.5
            boxes[:, 2:] += boxes[:, :2] + 0.1
            scores = rng.random(n).astype(np.float32)
            labels = rng.integers(0, 3, n)
            ref.append({"boxes": boxes, "scores": scores, "labels": labels})
            keep = rng.random(n) > 0.2
            qb = boxes[keep] + rng.normal(0, 0.02, (int(keep.sum()), 4)).astype(np.float32)
            ql = labels[keep].copy()
            ql[:1] = (ql[:1] + 1) % 3
            q.append({"boxes": qb, "scores": scores[keep] * 0.9, "labels": ql})
        ref_batches.append(ref)
        q_batches.append(q)

    def replay(lists):
        it = iter(lists)
        return lambda _x: next(it)

    empty = [[{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
               "labels": np.zeros(0, np.int64)}] * 2] * 2
    for refs, qs, thresh in ((ref_batches, q_batches, 0.25), (ref_batches, q_batches, 0.0), (empty, empty, 0.25)):
        ours = quant.measure_agreement_detection(replay(refs), replay(qs), range(len(refs)), score_thresh=thresh)
        theirs = jquant.measure_agreement_detection(replay(refs), replay(qs), range(len(refs)), score_thresh=thresh)
        assert ours == theirs
    assert ours["det_f1"] == 1.0 and ours["dets_per_image_ref"] == ours["dets_per_image_quant"] == 0.0
