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

:func:`quantize_model` copies a model and swaps each selected ``nn.Conv2d`` for a
:class:`QuantizedConv2d`; architecture code has no quantized variant. The same convs
are selected as in the JAX package: by the per-arch ``min_in_channels`` and
``quantize_strided`` fields of its ``models/_data/quant_policy.json``, of which
:data:`QUANT_POLICY` is the port's own copy (with ``quality_veto``). The speed fields
of that file were measured on a TPU and are not copied.
"""

import copy
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .kernels.int8_conv import pack_weights, quantize_activation, quantized_conv

__all__ = [
    "QINT_MAX",
    "QUANT_POLICY",
    "QuantizedConv2d",
    "QuantizedModel",
    "calibrate",
    "measure_agreement",
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
# fields are the JAX file's, and the JAX file's speeds are TPU figures): int8 img/s over
# bf16 img/s of `HOLOCRON_INT8_AGREEMENT=0 python -m holocron_tpu_torch.bench --arch
# <arch>` (batch 256, 224 px, both forms timed through the captured deploy forward) on an
# NVIDIA H100 80GB HBM3 at 700.00 W: repvgg_a0 49,069 / 37,596, resnet50 10,571 /
# 13,054, rexnet1_0x 17,613 / 17,934 img/s (PERF.md, section 6). `recommended` is
# int8_speedup >= 1.05, the JAX policy's rule (scripts/gen_quant_policy.py:91).
INT8_VERDICTS: Dict[str, Dict] = {
    "repvgg_a0": {"int8_speedup": 1.305, "recommended": True},
    "resnet50": {"int8_speedup": 0.81, "recommended": False},
    "rexnet1_0x": {"int8_speedup": 0.982, "recommended": False},
}


def selection_policy(arch: str) -> Optional[Dict]:
    """The fields of the per-arch policy that select which convs are int8, or None when
    ``arch`` has no entry. (The JAX package's ``s2d_strided`` field picks an exact
    rewrite of the same convs, not a selection.)"""
    entry = QUANT_POLICY.get(arch)
    return None if entry is None else {k: entry[k] for k in _SELECTION_FIELDS if k in entry}


def recommended_quantization(arch: str) -> Optional[Dict]:
    """The measured int8-against-bf16 verdict for ``arch`` on the card,
    ``{"int8_speedup": float, "recommended": bool}``, or None where it was not measured
    (``holocron_tpu/quant.py:56-67``); the service then serves the float form."""
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


class QuantizedConv2d(nn.Module):
    """An ``nn.Conv2d`` computed as int8 x int8 -> int32 with a float epilogue
    (``_quantized_conv``, ``quant.py:228-274``). NCHW in and out; the output has the
    input's dtype.

    ``w_scale`` and ``act_scale`` belong to the int8 arithmetic and stay float32 when
    the module's float remainder (the bias) is cast, e.g. by ``.to(torch.bfloat16)``.
    ``act_scale`` is None for a per-call (dynamic) activation scale. ``kernel_packed``
    is ``kernel_q`` as the wgmma route reads it (``pack_weights``, over the activation's
    16-byte channel pitch) for every ungrouped conv, None for a grouped one (the general
    route reads ``kernel_q``); a non-persistent buffer, remade when the module moves,
    so the ``state_dict`` holds ``kernel_q`` (HWIO, ``(KH, KW, C / groups, O)``) alone.
    """

    def __init__(
        self, conv: nn.Conv2d, kernel_q: torch.Tensor, w_scale: torch.Tensor, act_absmax: Optional[float] = None
    ) -> None:
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = conv.stride, conv.padding, conv.dilation, conv.groups
        device = conv.weight.device
        self.register_buffer("kernel_q", kernel_q.to(device))
        self.register_buffer("kernel_packed", self._packed(), persistent=False)
        self.register_buffer("w_scale", w_scale.to(device=device, dtype=torch.float32))
        act_scale = None
        if act_absmax is not None:
            # quant.py:241: clamp like the dynamic path, so a dead input cannot give s_x = 0
            act_scale = torch.tensor(act_absmax, dtype=torch.float32, device=device).clamp_min(1e-12) * _INV_QINT_MAX
        self.register_buffer("act_scale", act_scale)
        self.bias = None if conv.bias is None else nn.Parameter(conv.bias.detach().clone(), requires_grad=False)

    def _packed(self) -> Optional[torch.Tensor]:
        return pack_weights(self.kernel_q) if self.groups == 1 else None

    def _apply(self, fn, recurse=True):
        scales = {"w_scale": self.w_scale, "act_scale": self.act_scale}
        super()._apply(fn, recurse)
        for name, value in scales.items():  # follow device moves, not dtype casts
            if value is not None:
                setattr(self, name, value.to(self.kernel_q.device))
        self.kernel_packed = self._packed()
        return self

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.kernel_packed = self._packed()  # kernel_q may have changed in place

    def activation_scale(self, x: torch.Tensor) -> torch.Tensor:
        """The scale ``x`` is quantized with: the calibrated one, or else ``x``'s own,
        computed on its device (a graph capture takes no host sync)."""
        if self.act_scale is not None:
            return self.act_scale
        return x.detach().abs().amax().float().clamp_min(1e-12) * _INV_QINT_MAX

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s_x = self.activation_scale(x)
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

    def __init__(self, model: nn.Module, qparams: Dict[str, Dict[str, torch.Tensor]], act_scales: Optional[Dict[str, float]]):
        super().__init__()
        self.act_scales = act_scales
        self.model = copy.deepcopy(model).eval()
        modules = dict(self.model.named_modules())
        for path, rec in qparams.items():
            parent_path, _, name = path.rpartition(".")
            absmax = None if act_scales is None else act_scales.get(path)
            setattr(modules[parent_path], name, QuantizedConv2d(modules[path], rec["kernel_q"], rec["w_scale"], absmax))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


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


def quantize_model(
    model: nn.Module,
    calibration_batches: Optional[Iterable[torch.Tensor]] = None,
    min_in_channels: Optional[int] = None,
    arch: Optional[str] = None,
    quantize_strided: Optional[bool] = None,
) -> QuantizedModel:
    """Post-training-quantizes ``model`` for int8 inference (``quant.py:535-629``).

    Convs with fewer input channels than ``min_in_channels`` stay float. When it is
    None, the per-arch policy's value applies if ``arch`` has one, else 64. When
    ``quantize_strided`` is False only stride-1 convs are int8 (None: the policy's
    value, else True).

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
    return QuantizedModel(model, qparams, act_scales)
