#!/usr/bin/env python
"""int8 against bf16 on trained weights, the port of ``scripts/quant_accuracy.py``:

    python -m holocron_tpu_torch.quant_accuracy --archs repvgg_a0 resnet50 --out rows.jsonl
    python -m holocron_tpu_torch.quant_accuracy --archs repvgg_a0 --device cpu --steps 5 --batch 4 --size 32

The offline protocol (``quant_accuracy.py:1-19``): each arch is trained on a learnable
synthetic task drawn from seeds (10 classes of correlated noise and class templates; for
segmenters ellipse blobs of a class colour; for detectors class-coloured rectangles and
their boxes) until it separates them, then measured in the two forms the JAX script
builds (:func:`gate_forms`): the reference form, which the rows call "bf16", and the
selective-int8 form (:func:`~holocron_tpu_torch.quant.quantize_model`, calibrated on two
batches). Both compute what the script computes: float32 activations over weights
rounded through bf16 (the script casts the variables and not the images, and flax
promotes a float32 input over bf16 parameters to float32), the int8 convs writing
float32, with TF32 off (:func:`exact_float32`). Each form's accuracy against the task's
truth and the int8 gate against the reference (top-1 agreement and the largest softmax
drift; pixel agreement and mean mask IoU; box-F1 over the threshold ladder of
:func:`detection_ladder`). ``--checkpoint arch=path`` measures the ``torch.save`` state
dict at ``path`` instead of training.

One JSON row an arch, appended to ``--out`` as it is made (a later arch that fails keeps
the earlier rows), with the JAX script's keys and ``device`` (the card's name and power
limit from ``nvidia-smi``, or ``cpu``), ``steps`` and ``seconds``; then a markdown table.

Every draw comes from an explicit ``torch.Generator`` on the run's device (the task's
templates from seed 7, the training batches from 42, calibration from 1000 + i, the
accuracy batches from 2000, the gate's batches from 3000 + i), kept apart from the
arithmetic that turns draws into images (``*_draws`` and ``*_images``), so that the same
draws give the JAX script's images. Runs on the card unless ``--device cpu``.
"""

import argparse
import contextlib
import copy
import json
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

__all__ = [
    "MAX_CONSECUTIVE_ERRORS",
    "classification_draws",
    "classification_images",
    "detection_draws",
    "detection_images",
    "detection_ladder",
    "evaluate",
    "evaluate_dense",
    "exact_float32",
    "gate_forms",
    "infer_task",
    "main",
    "make_det_task",
    "make_seg_task",
    "make_task",
    "measure_detection",
    "measure_trained",
    "segmentation_draws",
    "segmentation_images",
    "train",
]

NUM_CLASSES = 10
# optax.apply_if_finite(max_consecutive_errors=50): an update with a non-finite gradient
# is skipped until the count of such updates in a row exceeds this, so the 51st is applied
MAX_CONSECUTIVE_ERRORS = 50
TRAIN_SEED = 42  # jax.random.key(42) in the JAX script's train
DET_BLOBS = 3


def _draw_normal(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _draw_uniform(gen: torch.Generator, low: float, high: float, *shape: int) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (high - low) + low


def _draw_int(gen: torch.Generator, low: int, high: int, *shape: int) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen, device=gen.device)


def upsample(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(x, (n, size, size, c), "bilinear")`` of an NHWC ``x`` smaller
    than ``size``. Only for upsampling: there ``jax.image.resize``'s triangle kernel
    reaches one input pixel each way and renormalizes at the border, which is torch's
    half-pixel bilinear with the border clamped; downsampling would widen JAX's kernel
    (an antialias), which torch's does not."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", align_corners=False,
                        antialias=False)
    return out.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch as NCHW: on the card a view (channels_last); on the CPU a contiguous
    copy, as the CPU's backward of a channels_last input into a contiguous model gave
    wrong gradients (and once crashed) under torch 2.13."""
    x = x.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


def _grid(size: int, device) -> tuple:
    """``jnp.mgrid[0:size, 0:size] / size``: the rows' and the columns' coordinates."""
    coords = torch.arange(size, dtype=torch.float32, device=device) / size
    return coords[:, None], coords[None, :]


# --- classification (quant_accuracy.py:30-48) ---


def classification_draws(gen: torch.Generator, n: int, num_classes: int, size: int) -> Dict[str, torch.Tensor]:
    """A batch's draws, in the JAX script's order: labels, coarse noise, fine noise (NHWC)."""
    return {"labels": _draw_int(gen, 0, num_classes, n),
            "coarse": _draw_normal(gen, n, size // 8, size // 8, 3),
            "fine": _draw_normal(gen, n, size, size, 3)}


def classification_images(templates: torch.Tensor, draws: Dict[str, torch.Tensor]) -> tuple:
    """``(x, y)``: upsampled coarse noise plus 0.9 of the label's template plus 0.3 of fine
    noise, standardized per image; ``x`` NCHW."""
    y = draws["labels"]
    x = upsample(draws["coarse"], templates.shape[1]) + 0.9 * templates[y] + 0.3 * draws["fine"]
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
    return _nchw((x - mean) / (std + 1e-6)), y


def make_task(gen: torch.Generator, num_classes: int, size: int) -> Callable:
    """The class-conditional task: a template per class drawn from ``gen`` now, and
    ``batch(gen, n) -> (x, y)``."""
    templates = upsample(_draw_normal(gen, num_classes, size // 8, size // 8, 3), size)

    def batch(batch_gen: torch.Generator, n: int) -> tuple:
        return classification_images(templates, classification_draws(batch_gen, n, num_classes, size))

    return batch


# --- segmentation (quant_accuracy.py:51-82) ---


def segmentation_draws(gen: torch.Generator, n: int, num_classes: int, size: int) -> Dict[str, torch.Tensor]:
    """A batch's draws: background noise, then for each of 3 blobs its class, centre
    (y, x), radii (y, x), activity draw and fill noise."""
    return {"background": _draw_normal(gen, n, size, size, 3),
            "classes": _draw_int(gen, 1, num_classes, n, 3),
            "centres": _draw_uniform(gen, 0.2, 0.8, n, 3, 2),
            "radii": _draw_uniform(gen, 0.08, 0.25, n, 3, 2),
            "active": torch.rand((n, 3), generator=gen, device=gen.device),
            "fill": _draw_normal(gen, n, 3, size, size, 3)}


def segmentation_images(signatures: torch.Tensor, draws: Dict[str, torch.Tensor]) -> tuple:
    """``(x, mask)``: up to 3 axis-aligned ellipses filled with their class's colour
    signature plus noise, later blobs overwriting earlier ones (the first always
    present, the others at 0.6); the mask holds each pixel's class, 0 for background."""
    n, size = draws["background"].shape[:2]
    yy, xx = _grid(size, signatures.device)
    x = 0.25 * draws["background"]
    mask = torch.zeros((n, size, size), dtype=torch.int64, device=x.device)
    for i in range(3):
        cls = draws["classes"][:, i]
        cy, cx = (draws["centres"][:, i, k, None, None] for k in (0, 1))
        ry, rx = (draws["radii"][:, i, k, None, None] for k in (0, 1))
        inside = torch.square((yy - cy) / ry) + torch.square((xx - cx) / rx) < 1.0
        inside = inside & (draws["active"][:, i] < (1.0 if i == 0 else 0.6))[:, None, None]
        mask = torch.where(inside, cls[:, None, None], mask)
        fill = signatures[cls][:, None, None, :] + 0.25 * draws["fill"][:, i]
        x = torch.where(inside[..., None], fill, x)
    return _nchw(x), mask


def make_seg_task(gen: torch.Generator, num_classes: int, size: int) -> Callable:
    """The dense task: a colour signature a class drawn from ``gen`` now, and
    ``batch(gen, n) -> (x, mask)``."""
    signatures = _draw_normal(gen, num_classes, 3) * 1.2

    def batch(batch_gen: torch.Generator, n: int) -> tuple:
        return segmentation_images(signatures, segmentation_draws(batch_gen, n, num_classes, size))

    return batch


# --- detection (quant_accuracy.py:85-121) ---


def detection_draws(gen: torch.Generator, n: int, num_classes: int, size: int) -> Dict[str, torch.Tensor]:
    """A batch's draws: background noise, then for each of 3 rectangles its class,
    centre (y, x), height and width, activity draw and fill noise."""
    return {"background": _draw_normal(gen, n, size, size, 3),
            "classes": _draw_int(gen, 0, num_classes, n, DET_BLOBS),
            "centres": _draw_uniform(gen, 0.25, 0.75, n, DET_BLOBS, 2),
            "extents": _draw_uniform(gen, 0.12, 0.3, n, DET_BLOBS, 2),
            "active": torch.rand((n, DET_BLOBS), generator=gen, device=gen.device),
            "fill": _draw_normal(gen, n, DET_BLOBS, size, size, 3)}


def detection_images(signatures: torch.Tensor, draws: Dict[str, torch.Tensor], max_boxes: int = 8) -> tuple:
    """``(x, target)``: up to 3 class-coloured rectangles (the first always present, the
    others at 0.5), and the padded target ``{boxes (n, max_boxes, 4) relative xyxy,
    labels, mask}`` of :func:`~holocron_tpu_torch.models.detection.pad_targets`' layout,
    an inactive slot's box zero."""
    n, size = draws["background"].shape[:2]
    yy, xx = _grid(size, signatures.device)
    x = 0.25 * draws["background"]
    boxes = torch.zeros((n, max_boxes, 4), dtype=torch.float32, device=x.device)
    labels = torch.zeros((n, max_boxes), dtype=torch.int64, device=x.device)
    mask = torch.zeros((n, max_boxes), dtype=torch.bool, device=x.device)
    for i in range(DET_BLOBS):
        cls = draws["classes"][:, i]
        cy, cx = draws["centres"][:, i, 0], draws["centres"][:, i, 1]
        h, w = draws["extents"][:, i, 0], draws["extents"][:, i, 1]
        x0, y0, x1, y1 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
        active = draws["active"][:, i] < (1.0 if i == 0 else 0.5)
        inside = ((yy >= y0[:, None, None]) & (yy < y1[:, None, None]) & (xx >= x0[:, None, None])
                  & (xx < x1[:, None, None]) & active[:, None, None])
        fill = signatures[cls][:, None, None, :] + 0.25 * draws["fill"][:, i]
        x = torch.where(inside[..., None], fill, x)
        boxes[:, i] = torch.where(active[:, None], torch.stack([x0, y0, x1, y1], dim=-1), 0.0)
        labels[:, i] = cls
        mask[:, i] = active
    return _nchw(x), {"boxes": boxes, "labels": labels, "mask": mask}


def make_det_task(gen: torch.Generator, num_classes: int, size: int, max_boxes: int = 8) -> Callable:
    """The detection task: a colour signature a class drawn from ``gen`` now, and
    ``batch(gen, n) -> (x, target)``."""
    signatures = _draw_normal(gen, num_classes, 3) * 1.2

    def batch(batch_gen: torch.Generator, n: int) -> tuple:
        return detection_images(signatures, detection_draws(batch_gen, n, num_classes, size), max_boxes)

    return batch


# --- training (quant_accuracy.py:124-176) ---


def _clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``: each gradient ``g / norm * max_norm`` unless the
    global norm is below ``max_norm``, on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    torch._foreach_div_(grads, torch.where(below, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(below, 1.0, max_norm))


def _loss(model: torch.nn.Module, x: torch.Tensor, y, task: str) -> torch.Tensor:
    if task == "detection":  # the loss dict a target gives (DetectionTrainer's contract)
        return sum(v.float() for v in model(x, y).values())
    return F.cross_entropy(model(x).float(), y)


def train(model: torch.nn.Module, batch_fn: Callable, steps: int, batch: int, lr: float = 1e-3,
          task: str = "classification") -> float:
    """Trains ``model`` in place in train mode: Adam at ``lr`` (detectors: a global-norm
    clip at 1.0, then Adam at ``lr / 4``), each batch ``batch_fn(gen, batch)`` from one
    generator seeded 42 on the model's device; dropout and stochastic depth draw from
    torch's global generators, forked and seeded 42 for the run.

    A step whose raw gradients hold a non-finite value is skipped (the parameters,
    Adam's moments and its step count stay as they were; BN statistics move, as the
    forward ran), unless it is past the :data:`MAX_CONSECUTIVE_ERRORS`-th such step in a
    row (``optax.apply_if_finite``). Returns the final loss, or where that is not finite
    the last finite one of the last 20 steps (NaN if none)."""
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr / 4 if task == "detection" else lr)
    gen = torch.Generator(device).manual_seed(TRAIN_SEED)
    model.train()
    errors, loss, last_finite = 0, None, float("nan")
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(TRAIN_SEED)
        for i in range(steps):
            x, y = batch_fn(gen, batch)
            loss = _loss(model, x, y, task)
            opt.zero_grad(set_to_none=False)
            loss.backward()
            for p in params:  # a parameter the loss does not reach takes a zero gradient, as in JAX
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            errors = 0 if finite else errors + 1
            if finite or errors > MAX_CONSECUTIVE_ERRORS:
                if task == "detection":
                    _clip_by_global_norm_(grads, 1.0)
                opt.step()
            if i >= steps - 20:  # a recent finite loss, not one blown-up final batch
                value = float(loss.detach())
                if value == value:
                    last_finite = value
    final = float("nan") if loss is None else float(loss.detach())
    return final if final == final else last_finite


# --- measurement (quant_accuracy.py:178-296) ---


@torch.no_grad()
def evaluate(fwd: Callable, batch_fn: Callable, gen: torch.Generator, batches: int, batch: int) -> float:
    """Top-1 accuracy of ``fwd``'s logits over ``batches`` batches drawn from ``gen``."""
    correct = total = 0
    for _ in range(batches):
        x, y = batch_fn(gen, batch)
        correct += int((fwd(x).argmax(-1) == y).sum())
        total += batch
    return correct / total


@torch.no_grad()
def evaluate_dense(fwd: Callable, batch_fn: Callable, gen: torch.Generator, batches: int, batch: int) -> float:
    """Pixel accuracy of ``fwd``'s NCHW logits against the masks."""
    correct = total = 0
    for _ in range(batches):
        x, y = batch_fn(gen, batch)
        correct += int((fwd(x).argmax(1) == y).sum())
        total += y.numel()
    return correct / total


def infer_task(arch: str) -> str:
    from .models import detection, segmentation

    if arch in detection.__dict__:
        return "detection"
    if arch in segmentation.__dict__:
        return "segmentation"
    return "classification"


def detection_ladder(raw_ref: Sequence, raw_q: Sequence, nms_thresh: float, score_thresh: float) -> tuple:
    """Both forms' detections on cached raw outputs ``(boxes, b_o, b_scores)`` a batch, at
    the first rung of the threshold ladder (objectness, score) (0.5, ``score_thresh``) ->
    (0.25, 0.01) -> (0.1, 1e-3) -> (0, the rank threshold) where the reference form gives
    at least 0.5 detections an image; the same thresholds for both forms.

    A detector trained a few hundred steps rarely pushes objectness past the production
    0.5, and a gate on no detections proves nothing. The last rung drops the objectness
    gate and takes the score that lets about 2 boxes an image pass in the reference form
    (a norm-free backbone can sit at any low absolute objectness). Post-processing runs
    in float32. Returns ``(ref, quant, {"obj_thresh", "score_thresh"})``, the
    detection lists batch by batch."""
    from .models.detection import detections_to_list, post_process

    scores = np.concatenate([(s.float().amax(-1) * o.float()).flatten().cpu().numpy() for _, o, s in raw_ref])
    per_image = raw_ref[0][1].shape[1]
    rank_t = float(np.quantile(scores, max(0.0, 1.0 - 2.0 / per_image)))

    def dets(raw, obj_t, score_t):
        return [detections_to_list(post_process(*(t.float() for t in r), nms_thresh, score_t, obj_thresh=obj_t))
                for r in raw]

    for obj_t, score_t in ((0.5, score_thresh), (0.25, 0.01), (0.1, 1e-3), (0.0, rank_t)):
        ref = dets(raw_ref, obj_t, score_t)
        if np.mean([len(d["boxes"]) for batch in ref for d in batch]) >= 0.5:
            break
    return ref, dets(raw_q, obj_t, score_t), {"obj_thresh": obj_t, "score_thresh": score_t}


@torch.no_grad()
def measure_detection(model, ref_fwd: Callable, int8_fwd: Callable, batch_fn: Callable, gen: torch.Generator,
                      batches: int, batch: int) -> Dict:
    """The detection row (``_measure_detection``): each form's box-F1 against the task's
    boxes (the accuracy) and the int8 form's against the reference form's (the gate,
    :func:`~holocron_tpu_torch.quant.measure_agreement_detection`), each form's raw
    forward run once a batch and the ladder walked over the cached outputs; the rung is
    recorded in the row."""
    from .quant import measure_agreement_detection

    eval_x, gts = [], []
    for _ in range(batches):
        x, tgt = batch_fn(gen, batch)
        eval_x.append(x)
        t = {k: v.cpu().numpy() for k, v in tgt.items()}
        gts.append([{"boxes": t["boxes"][j][t["mask"][j]], "scores": np.ones(int(t["mask"][j].sum())),
                     "labels": t["labels"][j][t["mask"][j]]} for j in range(batch)])
    raw_ref = [tuple(ref_fwd(x)) for x in eval_x]
    raw_int8 = [tuple(int8_fwd(x)) for x in eval_x]
    nms_thresh = getattr(model, "rpn_nms_thresh", 0.7)
    score_thresh = getattr(model, "box_score_thresh", 0.05)
    dets_ref, dets_int8, rung = detection_ladder(raw_ref, raw_int8, nms_thresh, score_thresh)

    def served(lists):
        it = iter(lists)
        return lambda _x: next(it)

    # score_thresh=0.0: the ladder thresholded already; the gate's default 0.25 would
    # empty the low-score rungs again
    def vs_truth(dets):
        return measure_agreement_detection(served(gts), served(dets), eval_x, score_thresh=0.0)

    gate = measure_agreement_detection(served(dets_ref), served(dets_int8), eval_x, score_thresh=0.0)
    return {
        **rung,
        "acc_bf16": round(vs_truth(dets_ref)["det_f1"], 4),
        "acc_int8": round(vs_truth(dets_int8)["det_f1"], 4),
        "det_f1": round(gate["det_f1"], 4),
        "det_precision": round(gate["det_precision"], 4),
        "det_recall": round(gate["det_recall"], 4),
        "mean_matched_iou": round(gate["mean_matched_iou"], 4),
        # 1.0 on no detections proves nothing: the counts show it
        "dets_per_image_bf16": round(gate["dets_per_image_ref"], 2),
        "dets_per_image_int8": round(gate["dets_per_image_quant"], 2),
    }


# --- the sweep (quant_accuracy.py:299-396) ---


def build_model(arch: str, device: torch.device, size: int) -> torch.nn.Module:
    """``arch``'s train form at its factory's defaults, random weights from seed 0
    (detectors without a backbone release; yolov1's head for ``size``), channels_last on
    the card."""
    from . import models

    kwargs = {"device": device, "generator": torch.Generator().manual_seed(0)}
    if arch in models.detection.__dict__:
        kwargs["pretrained_backbone"] = False
        if arch == "yolov1":
            kwargs["input_shape"] = (3, size, size)
    model = models.__dict__[arch](**kwargs)
    return model.to(memory_format=torch.channels_last) if device.type == "cuda" else model


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for cuDNN's convs and for matmuls in the block, both flags restored after
    it: the JAX script computes true float32 on the CPU, where cuDNN's default would
    round every float conv's input to 10 mantissa bits."""
    from .models.core import cudnn_settings

    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = False
        with cudnn_settings(allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


@torch.no_grad()
def _round_through_bf16_(module: torch.nn.Module, keep: frozenset = frozenset()) -> None:
    """Rounds every floating entry of ``module``'s state dict but those named in ``keep``
    to bf16 and back, in place; then each BatchNorm's ``running_var`` to the float32
    value whose sum with ``eps`` is the bf16 sum the JAX package computes over bf16
    statistics (``rsqrt(var + epsilon)``, ``holocron_tpu/models/layers.py:103`` and
    ``:123``, a sum that XLA keeps rounded to bf16)."""
    for name, t in module.state_dict(keep_vars=True).items():
        if t.is_floating_point() and name not in keep:
            t.copy_(t.to(torch.bfloat16))
    for m in module.modules():
        var = getattr(m, "running_var", None)
        if isinstance(var, torch.Tensor) and var.is_floating_point():
            var.copy_((var.to(torch.bfloat16) + m.eps).float() - m.eps)


def gate_forms(model: torch.nn.Module, calib: List[torch.Tensor], arch: str) -> Tuple[torch.nn.Module, torch.nn.Module]:
    """The gate's two forms of ``model`` (float32, eval, reparametrized where it can be),
    as ``scripts/quant_accuracy.py:340-349`` builds them; both run in float32 on float32
    images.

    - The reference form (the rows' "bf16"): a copy whose state dict, the JAX
      variables (parameters and BN statistics), is rounded through bf16
      (``jax.tree.map(... astype(bfloat16), model.variables)``), BN's ``var + eps``
      summed in bf16 as JAX sums it.
    - The int8 form: quantized from the float32 model, calibrated on ``calib``, so
      that ``kernel_q``, ``w_scale`` and the activation scales (JAX's ``qparams``) are
      the float32 model's; then the rest, which JAX's int8 apply reads from the bf16
      variables (the int8 convs' biases, the float convs, BN, the head), rounded as
      the reference form's is.

    Run with TF32 off (:func:`exact_float32`), calibration included."""
    from .quant import QuantizedConv2d, quantize_model

    ref = copy.deepcopy(model).eval()
    _round_through_bf16_(ref)
    with torch.no_grad():
        qm = quantize_model(model, calibration_batches=calib, arch=arch)
    qparams = frozenset(f"{path}.{name}" for path, m in qm.named_modules() if isinstance(m, QuantizedConv2d)
                        for name in ("w_scale", "act_scale"))
    _round_through_bf16_(qm, keep=qparams)
    return ref, qm


def measure_trained(model: torch.nn.Module, arch: str, task: str, batch_fn: Callable, seeded: Callable,
                    eval_batches: int, batch: int) -> Dict:
    """The measured part of ``arch``'s row, ``model`` trained and in its eval form:
    calibration on the batches of ``seeded(1000)`` and ``seeded(1001)``, both
    :func:`gate_forms` under :func:`exact_float32`, each form's accuracy on the batches
    drawn from ``seeded(2000)`` and the gate on those of ``seeded(3000 + i)`` (a
    detector's on the accuracy batches), ``seeded(seed)`` giving what ``batch_fn`` draws
    from."""
    from .quant import measure_agreement, measure_agreement_segmentation

    calib = [batch_fn(seeded(1000 + i), batch)[0] for i in range(2)]
    with exact_float32():
        ref, qm = gate_forms(model, calib, arch)
        if task == "detection":
            return measure_detection(model, ref.raw, qm.raw, batch_fn, seeded(2000), eval_batches, batch)
        eval_x = [batch_fn(seeded(3000 + i), batch)[0] for i in range(eval_batches)]
        score = evaluate_dense if task == "segmentation" else evaluate
        acc_ref = score(ref, batch_fn, seeded(2000), eval_batches, batch)
        acc_int8 = score(qm, batch_fn, seeded(2000), eval_batches, batch)
        row = {"acc_bf16": round(acc_ref, 4), "acc_int8": round(acc_int8, 4)}
        if task == "segmentation":
            gate = measure_agreement_segmentation(ref, qm, eval_x)
            row.update(pixel_agreement=round(gate["pixel_agreement"], 4),
                       mean_mask_iou=round(gate["mean_mask_iou"], 4))
        else:
            gate = measure_agreement(ref, qm, eval_x)
            row.update(top1_agreement=round(gate["top1_agreement"], 4),
                       max_prob_drift=round(gate["max_prob_drift"], 5))
    return row


def measure_arch(arch: str, args, device: torch.device, checkpoint: Optional[str] = None) -> Dict:
    """One arch's row: trained (or loaded), reparametrized where it can be, both forms
    measured (:func:`measure_trained`)."""
    from .utils.misc import device_label

    t0 = time.perf_counter()
    task = infer_task(arch)
    size = args.size if task == "classification" else max(args.size, {"segmentation": 64, "detection": 128}[task])
    batch = args.batch if task == "classification" else min(args.batch, 16)
    model = build_model(arch, device, size)
    make = {"classification": make_task, "segmentation": make_seg_task, "detection": make_det_task}[task]
    batch_fn = make(torch.Generator(device).manual_seed(7), NUM_CLASSES, size)
    if checkpoint is not None:
        state = torch.load(checkpoint, map_location=device, weights_only=True)
        model.load_state_dict(state.get("model", state))
        final_loss = float("nan")
    else:
        final_loss = train(model, batch_fn, args.steps, batch, task=task)
    model.eval()
    if hasattr(model, "reparametrize"):
        model.reparametrize()

    row = measure_trained(model, arch, task, batch_fn, lambda seed: torch.Generator(device).manual_seed(seed),
                          args.eval_batches, batch)
    weights = "checkpoint" if checkpoint is not None else f"trained {args.steps} steps (loss {final_loss:.3f})"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"arch": arch, "task": task, "weights": weights, **row, "device": device_label(device),
            "steps": 0 if checkpoint is not None else args.steps, "seconds": round(time.perf_counter() - t0, 1)}


def main(args) -> List[Dict]:
    """The sweep over ``args.archs``; returns the rows it printed."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    checkpoints = dict(kv.split("=", 1) for kv in args.checkpoint)
    rows = []
    for arch in args.archs:
        row = measure_arch(arch, args, device, checkpoints.get(arch))
        rows.append(row)
        print(json.dumps(row), flush=True)  # noqa: T201
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    print("\n| arch | task | weights | bf16 acc | int8 acc | agreement |")  # noqa: T201
    print("|---|---|---|---|---|---|")  # noqa: T201
    for r in rows:
        agreement = r.get("top1_agreement", r.get("pixel_agreement", r.get("det_f1", math.nan)))
        print(f"| {r['arch']} | {r['task']} | {r['weights']} | {r['acc_bf16']:.3f} | {r['acc_int8']:.3f} "  # noqa: T201
              f"| {agreement:.3f} |")
    return rows


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--archs", nargs="+", default=["repvgg_a0", "resnet50"])
    p.add_argument("--steps", default=300, type=int)
    p.add_argument("--batch", default=64, type=int)
    p.add_argument("--size", default=64, type=int)
    p.add_argument("--eval-batches", default=4, type=int)
    p.add_argument("--checkpoint", nargs="*", default=[], help="arch=path pairs (torch.save state dicts)")
    p.add_argument("--out", default="", help="append JSONL rows here")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
