"""Post-training int8 quantization for deploy-form inference: the port of
``holocron_tpu/quant.py``.

- **Weights**: per-output-channel symmetric int8, ``w_scale[o] = max(absmax(W[o]), 1e-12) / 127``.
- **Activations**: per-tensor symmetric int8, ``s_x = max(absmax(x), 1e-12) / 127``,
  calibrated on sample batches by forward pre-hooks, or computed per call without them.
  Quantizing is ``clip(round_half_even(x / s_x), -127, 127)``: :func:`quantize_activation`,
  a kernel on the card and its plain PyTorch version (``quantize_activation_plain``) on
  the CPU.
- **Compute**: quantization, the int8 x int8 -> int32 conv and its epilogue
  ``acc * (s_x * w_scale) + bias`` run in :func:`.kernels.int8_conv.quantized_conv` (two
  CUDA launches a layer on the card; the quantized activation lies at a 16-byte channel
  pitch, and the weights of every ungrouped conv are packed once per layer over it).
- **s2d_strided** (opt-in, ``quant.py:213-257``): a 3x3 stride-2 pad-1 conv on an even
  input runs as the 2x2 stride-1 conv of its folded kernel over the space-to-depth(2)
  of ``x_q``, padded on top and left by one zero row and column in the same copy
  (:func:`~holocron_tpu_torch.models.utils.space_to_depth_padded`): the same int32
  accumulators, bit for bit, from a stride-1 conv over 4x the channels.

:func:`quantize_model` copies a model and swaps each selected ``nn.Conv2d`` for a
:class:`QuantizedConv2d`; architecture code has no quantized variant. The same convs
are selected as in the JAX package: by the per-arch ``min_in_channels`` and
``quantize_strided`` fields of its ``models/_data/quant_policy.json``, of which
:data:`QUANT_POLICY` is the port's own copy (with ``quality_veto``). The speed fields
of that file were measured on a TPU and are not copied: :data:`INT8_VERDICTS` reads the
port's own ``models/_data/quant_policy.json``, generated from the card's rows
(:mod:`.gen_quant_policy`).
"""

import copy
import json
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .kernels.int8_conv import (
    channel_pitch, conv_route, int8_conv, pack_weights, quantize_activation, quantized_conv,
)
from .models.utils import fold_s2d_kernel, space_to_depth_padded

__all__ = [
    "QINT_MAX",
    "QUANT_POLICY",
    "QuantizedConv2d",
    "QuantizedModel",
    "calibrate",
    "measure_agreement",
    "measure_agreement_detection",
    "measure_agreement_segmentation",
    "quantize_activation",
    "quantize_conv_params",
    "quantize_model",
    "recommended_quantization",
    "selection_policy",
]

QINT_MAX = 127.0
# Scales are abs-max times float32(1 / 127): XLA turns the JAX package's division by
# the constant 127 into this product, so the port's scales agree with it bit for bit.
_INV_QINT_MAX = 1.0 / QINT_MAX

# The per-arch fields of the JAX package's quant_policy.json that the port reads, copied
# field for field (tests/test_torch_quant.py holds the copy against the file). An arch
# with none of these fields has no entry.
QUANT_POLICY: Dict[str, Dict] = {
    "repvgg_a0": {"min_in_channels": 48},
    "yolov2": {
        "quality_veto": (
            "int8 box-F1 vs bf16 = 0.893 (recall 0.806, matched IoU 0.819) on trained weights "
            "(2000 steps, loss 2.21) \u2014 int8 drops ~19% of bf16's detections; "
            "docs/bench/quant_accuracy_segdet.jsonl row 2026-08-20. Speed 1.11x does not clear "
            "the quality gate (yolov1 F1 1.0, yolov4 0.979-0.986 pass)."
        )
    },
}
_SELECTION_FIELDS = ("min_in_channels", "quantize_strided")

# The int8 form's speed against bf16 on the card, kept apart from QUANT_POLICY (whose
# fields are the JAX file's, and the JAX file's speeds are TPU figures): the port's own
# models/_data/quant_policy.json, which gen_quant_policy.py writes from the card's
# bench_zoo rows in models/_data/bench/ (each row names the card and its power limit),
# `recommended` at int8_speedup >= 1.05 and vetoed where the card's trained-weight
# quant_accuracy row fails its gate.
_PORT_POLICY = Path(__file__).resolve().parent / "models" / "_data" / "quant_policy.json"
INT8_VERDICTS: Dict[str, Dict] = {
    arch: {k: entry[k] for k in ("int8_speedup", "recommended")}
    for arch, entry in json.loads(_PORT_POLICY.read_text()).items()
}


def selection_policy(arch: str) -> Optional[Dict]:
    """The fields of the per-arch policy that select which convs are int8, or None when
    ``arch`` has no entry. (The JAX package's ``s2d_strided`` field picks an exact
    rewrite of the same convs, not a selection.)"""
    entry = QUANT_POLICY.get(arch)
    return None if entry is None else {k: entry[k] for k in _SELECTION_FIELDS if k in entry}


def recommended_quantization(arch: str) -> Optional[Dict]:
    """The measured int8-against-bf16 verdict for ``arch`` on the card,
    ``{"int8_speedup": float, "recommended": bool}`` from :data:`INT8_VERDICTS`, or None
    where it was not measured (``holocron_tpu/quant.py:56-67``); the service then serves
    the float form."""
    verdict = INT8_VERDICTS.get(arch)
    return None if verdict is None else dict(verdict)


def _is_quantizable_conv(module: nn.Module) -> bool:
    # type(...) is, as in quant.py:93: subclasses may have other semantics
    return type(module) is nn.Conv2d and module.padding_mode == "zeros" and not isinstance(module.padding, str)


@torch.no_grad()
def quantize_conv_params(model: nn.Module, conv_paths: Sequence[str]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-output-channel symmetric int8 quantization of the named convs
    (``quant.py:159-179``).

    Returns ``{path: {"kernel_q": int8 HWIO, "w_scale": float32 (O,)}}``.
    """
    modules = dict(model.named_modules())
    out = {}
    for path in conv_paths:
        kernel = modules[path].weight.float().permute(2, 3, 1, 0)  # OIHW -> HWIO
        w_scale = kernel.abs().amax(dim=(0, 1, 2)).clamp_min(1e-12) * _INV_QINT_MAX
        kernel_q = torch.round(kernel / w_scale).clamp_(-QINT_MAX, QINT_MAX).to(torch.int8)
        out[path] = {"kernel_q": kernel_q.contiguous(), "w_scale": w_scale}
    return out


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor]) -> Dict[str, float]:
    """Runs ``batches`` through ``model`` in eval mode, recording each quantizable
    conv input's abs-max, the maximum over all batches (``quant.py:113-145``).

    Returns ``{conv_path: abs-max}``.
    """
    absmax: Dict[str, torch.Tensor] = {}

    def hook_for(path: str) -> Callable:
        def hook(_module, args):
            m = args[0].detach().abs().amax().float()
            absmax[path] = m if path not in absmax else torch.maximum(absmax[path], m)

        return hook

    handles = [
        m.register_forward_pre_hook(hook_for(path)) for path, m in model.named_modules() if _is_quantizable_conv(m)
    ]
    was_training = model.training
    model.eval()
    try:
        for batch in batches:
            model(batch)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return {path: float(v) for path, v in absmax.items()}


def _s2d_eligible(kernel_q: torch.Tensor, stride, padding, dilation, groups: int) -> bool:
    """A dense 3x3 stride-2 pad-1 conv has an exact 2x2 stride-1 form over the
    space-to-depth input (``quant.py:213-226``), on an input of even H and W (which
    :class:`QuantizedConv2d` checks a call)."""
    return (
        tuple(kernel_q.shape[:2]) == (3, 3)
        and tuple(stride) == (2, 2)
        and tuple(padding) == (1, 1)
        and tuple(dilation) == (1, 1)
        and groups == 1
    )


def _fold_hwio(kernel_q: torch.Tensor) -> torch.Tensor:
    """:func:`fold_s2d_kernel` of an HWIO kernel, HWIO ``(2, 2, 4C, O)``."""
    return fold_s2d_kernel(kernel_q.permute(3, 2, 0, 1)).permute(2, 3, 1, 0).contiguous()


class QuantizedConv2d(nn.Module):
    """An ``nn.Conv2d`` computed as int8 x int8 -> int32 with a float epilogue
    (``_quantized_conv``, ``quant.py:228-274``). NCHW in and out; the output has the
    input's dtype.

    ``s2d_strided``: where the conv is :func:`_s2d_eligible`, ``kernel_s2d_q`` is the
    kernel folded once (HWIO ``(2, 2, 4C, O)``) and ``kernel_s2d_packed`` its packing over
    the pitch of 4C (both non-persistent buffers, remade from ``kernel_q``); an input of
    even H and W then goes through the folded conv (``quant.py:246-257``), an odd one
    through the stride-2 conv.

    ``w_scale`` and ``act_scale`` belong to the int8 arithmetic and stay float32 when
    the module's float remainder (the bias) is cast, e.g. by ``.to(torch.bfloat16)``.
    ``act_scale`` is None for a per-call (dynamic) activation scale. ``kernel_packed``
    is ``kernel_q`` as the wgmma, halo and pointwise routes read it (``pack_weights``,
    over the activation's 16-byte channel pitch) for every ungrouped conv, None for a
    grouped one (the general route reads ``kernel_q``); a non-persistent buffer, remade when the module moves,
    so the ``state_dict`` holds ``kernel_q`` (HWIO, ``(KH, KW, C / groups, O)``) alone.
    """

    def __init__(
        self, conv: nn.Conv2d, kernel_q: torch.Tensor, w_scale: torch.Tensor, act_absmax: Optional[float] = None,
        s2d_strided: bool = False,
    ) -> None:
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = conv.stride, conv.padding, conv.dilation, conv.groups
        self.s2d = s2d_strided and _s2d_eligible(kernel_q, self.stride, self.padding, self.dilation, self.groups)
        device = conv.weight.device
        self.register_buffer("kernel_q", kernel_q.to(device))
        self.register_buffer("kernel_packed", self._packed(), persistent=False)
        self.register_buffer("kernel_s2d_q", None, persistent=False)
        self.register_buffer("kernel_s2d_packed", None, persistent=False)
        self._fold()
        self.register_buffer("w_scale", w_scale.to(device=device, dtype=torch.float32))
        act_scale = None
        if act_absmax is not None:
            # quant.py:241: clamp like the dynamic path, so a dead input cannot give s_x = 0
            act_scale = torch.tensor(act_absmax, dtype=torch.float32, device=device).clamp_min(1e-12) * _INV_QINT_MAX
        self.register_buffer("act_scale", act_scale)
        self.bias = None if conv.bias is None else nn.Parameter(conv.bias.detach().clone(), requires_grad=False)

    def _packed(self) -> Optional[torch.Tensor]:
        return pack_weights(self.kernel_q) if self.groups == 1 else None

    @property
    def route(self) -> str:
        """The CUDA route its forward launches (:func:`.kernels.int8_conv.conv_route`) on
        an input of at least ``HALO_MIN_ROWS`` output pixels: the conv's, or where the
        conv is ``s2d_strided`` the route of its fold, a 2x2 stride-1 unpadded conv over
        4C channels, which an input of even H and W takes. :meth:`route_for` gives any
        input's."""
        return self.route_for(None)

    def route_for(self, x: Optional[torch.Tensor]) -> str:
        """The CUDA route its forward launches on the NCHW ``x`` (None: :attr:`route`):
        a halo-route conv launched on fewer than ``HALO_MIN_ROWS`` output pixels takes
        the wgmma route."""
        kh, kw, c, o = self.kernel_q.shape
        if x is not None:
            n, _, h, w = x.shape
        if self.s2d and (x is None or (h % 2 == 0 and w % 2 == 0)):
            return conv_route(4 * c, o, kernel_size=(2, 2), rows=None if x is None else n * (h // 2) * (w // 2))
        rows = None
        if x is not None:
            (sh, sw), (ph, pw), (dh, dw) = self.stride, self.padding, self.dilation
            rows = n * ((h + 2 * ph - dh * (kh - 1) - 1) // sh + 1) * ((w + 2 * pw - dw * (kw - 1) - 1) // sw + 1)
        return conv_route(c, o, self.groups, kernel_size=(kh, kw), stride=self.stride, padding=self.padding,
                          dilation=self.dilation, rows=rows)

    def _fold(self) -> None:
        if self.s2d:
            self.kernel_s2d_q = _fold_hwio(self.kernel_q)
            self.kernel_s2d_packed = pack_weights(self.kernel_s2d_q)

    def _apply(self, fn, recurse=True):
        scales = {"w_scale": self.w_scale, "act_scale": self.act_scale}
        super()._apply(fn, recurse)
        for name, value in scales.items():  # follow device moves, not dtype casts
            if value is not None:
                setattr(self, name, value.to(self.kernel_q.device))
        self.kernel_packed = self._packed()
        self._fold()
        return self

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.kernel_packed = self._packed()  # kernel_q may have changed in place
        self._fold()

    def activation_scale(self, x: torch.Tensor) -> torch.Tensor:
        """The scale ``x`` is quantized with: the calibrated one, or else ``x``'s own,
        computed on its device (a graph capture takes no host sync)."""
        if self.act_scale is not None:
            return self.act_scale
        return x.detach().abs().amax().float().clamp_min(1e-12) * _INV_QINT_MAX

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s_x = self.activation_scale(x)
        if self.s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            # quant.py:246-257: x_q rearranged and padded in one copy, at the pitch of 4C
            x_q = quantize_activation(x.permute(0, 2, 3, 1), s_x)
            z = space_to_depth_padded(x_q, pitch=channel_pitch(4 * x_q.shape[-1]))
            y = int8_conv(z, self.kernel_s2d_q, s_x, self.w_scale, self.bias, 1, 0, 1, 1, out_dtype=x.dtype,
                          w_packed=self.kernel_s2d_packed)
            return y.permute(0, 3, 1, 2)
        # NHWC: a free view when x is channels_last, as on the card
        y = quantized_conv(
            x.permute(0, 2, 3, 1), s_x, self.kernel_q, self.w_scale, self.bias,
            self.stride, self.padding, self.dilation, out_dtype=x.dtype, w_packed=self.kernel_packed,
            groups=self.groups,
        )
        return y.permute(0, 3, 1, 2)


class QuantizedModel(nn.Module):
    """The int8-inference form of a model (``quant.py:277-380``): a copy of it whose
    selected convs are :class:`QuantizedConv2d`. Built by :func:`quantize_model`;
    called like the model (eval forward)."""

    def __init__(self, model: nn.Module, qparams: Dict[str, Dict[str, torch.Tensor]], act_scales: Optional[Dict[str, float]],
                 s2d_strided: bool = False):
        super().__init__()
        self.act_scales = act_scales
        self.s2d_strided = s2d_strided
        self.model = copy.deepcopy(model).eval()
        modules = dict(self.model.named_modules())
        for path, rec in qparams.items():
            parent_path, _, name = path.rpartition(".")
            absmax = None if act_scales is None else act_scales.get(path)
            setattr(modules[parent_path], name,
                    QuantizedConv2d(modules[path], rec["kernel_q"], rec["w_scale"], absmax, s2d_strided))

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)

    def raw(self, x: torch.Tensor):
        """A detector's raw forward (``DetectionModel.raw``) with the int8 convs: the
        function that is quantized, where post-processing stays float."""
        return self.model.raw(x)


@torch.no_grad()
def measure_agreement(
    ref_fwd: Callable, quant_fwd: Callable, batches: Iterable[torch.Tensor]
) -> Dict[str, float]:
    """Accuracy gate between a reference forward and its quantized form
    (``quant.py:382-407``): the fraction of matching argmax predictions and the
    largest softmax-probability gap."""
    agree = total = 0
    drift = 0.0
    for x in batches:
        p_ref = F.softmax(ref_fwd(x).float(), dim=-1)
        p_q = F.softmax(quant_fwd(x).float(), dim=-1)
        agree += int((p_ref.argmax(-1) == p_q.argmax(-1)).sum())
        total += int(x.shape[0])
        drift = max(drift, float((p_ref - p_q).abs().max()))
    return {"top1_agreement": agree / max(total, 1), "max_prob_drift": drift}


@torch.no_grad()
def measure_agreement_segmentation(
    ref_fwd: Callable, quant_fwd: Callable, batches: Iterable[torch.Tensor]
) -> Dict[str, float]:
    """The dense gate between a segmentation model's reference form and its quantized
    form (``quant.py:410-450``), on NCHW logits ``(B, C, H, W)``: the fraction of pixels
    whose argmax class agrees, and the mean over the classes present in either argmax
    mask of their IoU, the reference's mask taken as ground truth. Counts accumulate on
    the device and are read once; NaN for both where ``batches`` is empty (no evidence),
    a mean IoU of 1.0 where no class is present."""
    agree = total = inter = union = None
    for x in batches:
        l_ref, l_q = ref_fwd(x), quant_fwd(x)
        num_classes = l_ref.shape[1]
        m_ref, m_q = l_ref.argmax(1).flatten(), l_q.argmax(1).flatten()
        same = m_ref == m_q
        # per class: pixels where both masks hold it, and pixels of it in each mask
        # (``bincount``'s extra bin takes the disagreeing pixels)
        both = torch.bincount(torch.where(same, m_ref, num_classes), minlength=num_classes + 1)[:num_classes]
        either = torch.bincount(m_ref, minlength=num_classes) + torch.bincount(m_q, minlength=num_classes) - both
        n = same.sum()
        agree, inter, union = (n, both, either) if agree is None else (agree + n, inter + both, union + either)
        total = (0 if total is None else total) + m_ref.numel()
    if agree is None:
        return {"pixel_agreement": float("nan"), "mean_mask_iou": float("nan")}
    counts = torch.cat([agree.reshape(1), inter, union]).cpu().numpy()
    agree, (inter, union) = int(counts[0]), counts[1:].reshape(2, -1)
    present = union > 0
    ious = inter[present] / union[present]
    return {"pixel_agreement": agree / max(total, 1), "mean_mask_iou": float(ious.mean()) if ious.size else 1.0}


def _xyxy_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def measure_agreement_detection(
    ref_fwd: Callable, quant_fwd: Callable, batches: Iterable, iou_thresh: float = 0.5, score_thresh: float = 0.25
) -> Dict[str, float]:
    """The box-level gate between a detector's reference form and its quantized form
    (``quant.py:455-532``, term for term, in numpy on the host).

    ``ref_fwd`` and ``quant_fwd`` return the per-image lists of ``{boxes, scores,
    labels}`` dicts a detector's eval forward gives. The detections scoring at least
    ``score_thresh`` are matched greedily (same label, IoU >= ``iou_thresh``, by
    descending reference score), the reference's taken as pseudo ground truth. Returns
    the precision, recall and F1 of the quantized detections against the reference's,
    the mean IoU of the matched pairs, and the detections an image of each form
    (``dets_per_image_ref``, ``dets_per_image_quant``), which show an agreement of 1.0
    on no boxes at all for what it is (then every score is 1.0: vacuous).
    """
    tp = fp = fn = 0
    n_ref = n_quant = n_images = 0
    matched_iou_sum = 0.0
    for x in batches:
        for det_ref, det_q in zip(ref_fwd(x), quant_fwd(x)):
            keep_r = np.asarray(det_ref["scores"]) >= score_thresh
            keep_q = np.asarray(det_q["scores"]) >= score_thresh
            boxes_r = np.asarray(det_ref["boxes"], dtype=np.float64)[keep_r]
            boxes_q = np.asarray(det_q["boxes"], dtype=np.float64)[keep_q]
            labels_r = np.asarray(det_ref["labels"])[keep_r]
            labels_q = np.asarray(det_q["labels"])[keep_q]
            order = np.argsort(-np.asarray(det_ref["scores"], dtype=np.float64)[keep_r])
            iou = _xyxy_iou(boxes_r, boxes_q) if len(boxes_r) and len(boxes_q) else None
            taken = np.zeros(len(boxes_q), dtype=bool)
            matched = 0
            for i in order:
                if iou is None:
                    break
                cand = iou[i] * (labels_q == labels_r[i]) * ~taken
                j = int(cand.argmax()) if cand.size else -1
                if j >= 0 and cand[j] >= iou_thresh:
                    taken[j] = True
                    matched += 1
                    matched_iou_sum += float(cand[j])
            tp += matched
            fn += len(boxes_r) - matched
            fp += len(boxes_q) - matched
            n_ref += len(boxes_r)
            n_quant += len(boxes_q)
            n_images += 1
    counts = {"dets_per_image_ref": n_ref / max(n_images, 1), "dets_per_image_quant": n_quant / max(n_images, 1)}
    if tp + fp + fn == 0:
        return {"det_precision": 1.0, "det_recall": 1.0, "det_f1": 1.0, "mean_matched_iou": 1.0, **counts}
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {
        "det_precision": precision,
        "det_recall": recall,
        "det_f1": 2 * precision * recall / max(precision + recall, 1e-9),
        "mean_matched_iou": matched_iou_sum / max(tp, 1),
        **counts,
    }


def quantize_model(
    model: nn.Module,
    calibration_batches: Optional[Iterable[torch.Tensor]] = None,
    min_in_channels: Optional[int] = None,
    arch: Optional[str] = None,
    quantize_strided: Optional[bool] = None,
    s2d_strided: Optional[bool] = None,
) -> QuantizedModel:
    """Post-training-quantizes ``model`` for int8 inference (``quant.py:535-629``).

    Convs with fewer input channels than ``min_in_channels`` stay float. When it is
    None, the per-arch policy's value applies if ``arch`` has one, else 64. When
    ``quantize_strided`` is False only stride-1 convs are int8 (None: the policy's
    value, else True). ``s2d_strided`` runs each selected 3x3 stride-2 conv as its exact
    space-to-depth form (:class:`QuantizedConv2d`); None: the policy's ``s2d_strided``
    field, else off (no arch has one).

    Args:
        model: a model, reparametrized first where it supports it (BN folding
            before quantization is standard practice)
        calibration_batches: sample inputs for static activation scales; without
            them the scales are computed per call
        min_in_channels, arch, quantize_strided: the selection above
    """
    policy = (selection_policy(arch) if arch is not None else None) or {}
    if min_in_channels is None:
        min_in_channels = policy.get("min_in_channels", 64)
    if quantize_strided is None:
        quantize_strided = bool(policy.get("quantize_strided", True))
    if calibration_batches is not None:
        calibration_batches = list(calibration_batches)
        if not calibration_batches:
            raise ValueError(
                "calibration_batches is empty (was it a generator consumed earlier?): "
                "pass at least one batch, or None for dynamic activation scales"
            )
    paths: List[str] = [
        path
        for path, m in model.named_modules()
        if _is_quantizable_conv(m)
        and m.in_channels // m.groups >= min_in_channels
        and (quantize_strided or all(s == 1 for s in m.stride))
    ]
    qparams = quantize_conv_params(model, paths)
    act_scales = calibrate(model, calibration_batches) if calibration_batches is not None else None
    if s2d_strided is None:
        s2d_strided = bool(QUANT_POLICY.get(arch, {}).get("s2d_strided", False))
    return QuantizedModel(model, qparams, act_scales, s2d_strided)
