#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``holocron_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line to stdout:

1. ``build``: ``nvcc`` builds every kernel from ``holocron_tpu_torch/csrc`` (one process
   per source, all at once).
2. ``serving``: the repvgg_a0 deploy path of ``bench.py`` at full width (224 px, 10
   classes, random weights from a seed): BN statistics adapted on 4 naturalistic
   batches in train mode, ``reparametrize()`` (train-form eval against deploy drift,
   float32), bf16 deploy requests (8 of batch 8, one of batch 256), the selective-int8
   form calibrated on one batch, the top-1 agreement gate (>= 0.99, ``bench.py:156``)
   on 2 held-out batches, the same requests in int8, and bf16 / int8 throughput. A
   gate miss is reported (``served_form``); it does not fail the run. Each int8 layer
   launches, a forward, the quantization kernel and the conv of the route
   ``conv_route`` picks for it: here every one the ``wgmma`` route, none the general
   route. (After the checks, a ``serving_profile`` line: ``torch.profiler`` over the
   int8 and bf16 forwards at batch 256 and 8.)
3. ``resnet_serving``: the same path for resnet50 (10 classes, 23,528,522 parameters):
   no reparametrization (BN stays after each conv, as the JAX package serves a ResNet),
   52 ``wgmma`` convs (every conv but the 3-channel stem). (Last, a
   ``resnet_serving_profile`` line.)
4. ``rexnet_serving``: the same path for rexnet1_0x, the API's default model
   (``api/app/config.py:8``; 3,527,996 parameters at 10 classes), BN kept: 44 int8
   convs, all on ``wgmma`` (41 of them at C % 16 != 0 or O % 8 != 0: x_q at its 16-byte
   channel pitch, the masked epilogue; the SE convs' 1 x 1 inputs), none on the
   general route. (Last, a ``rexnet_serving_profile`` line.)
5. ``involution``: ``Involution2d`` at ``scripts/bench_ops.py:82-87``'s shape (N32,
   56x56, C128, G8, k7, reduction 2, bf16) through the module: the tiled route's forward
   (``csrc/involution.cu``, a halo tile in shared memory), which must launch, and never
   the general route's.
6. ``training``: the repvgg_a0 classification trainer at full width (224 px, batch 128,
   10 classes, random weights from a seed) on synthetic uint8 NCHW batches, as
   ``references/classification/train.py:204-302`` builds it: bf16 compute (``amp``),
   LAMB (lr 1e-3, weight decay 5e-5) under a onecycle schedule, label smoothing 0.1,
   ``gradient_clip=1.0``, ``gradient_acc=2``, ``skip_nan_loss=True``, ImageNet
   ``input_norm``. One epoch of 8 batches and ``evaluate()`` on 2, a timed window of
   steps, one step on a float32 batch holding a NaN (which must be skipped: params,
   moments and the optimizer's count unchanged), and ``check_setup`` for 10 steps on a
   fresh model (the loss must fall).
7. ``resnet_training`` and ``rexnet_training``: resnet50 and rexnet1_0x in the same
   trainer and settings, one epoch of 4 batches (2 updates), ``evaluate()`` on one, and
   a timed window of steps.
8. ``involution_train``: ``Involution2d`` at the same shape, forward and backward
   through the module in bf16: the forward and both gradient kernels of the tiled route,
   which must launch, and none of the general route's. Its step time from CUDA events
   (``fwd_bwd_ms``), which the host sets once the step's kernels take less time than
   their launches, and the step's summed kernel time (``fwd_bwd_kernel_ms``, the same
   for ``add2d``).
9. ``add2d``: ``Add2d(64 -> 128, k3, pad 1)`` on N4 x 56 x 56 in float32, forward and
   backward through the module (``scripts/bench_ops.py:112-113``'s layer: L 12544,
   D 576, O 128).
10. ``resnet_zoo``: one eval forward each of resnet50d, resnext50_32x4d, res2net50_26w_4s,
   sknet50, tridentnet50, pyconv_resnet50 and pyconvhg_resnet50 at full width, 224 px,
   batch 32, in float32 and bf16: parameter count, bf16-vs-f32 logits, bf16 img/s.
11. ``nn_catalog``: each module and function of the nn catalog (activations, losses,
   DropBlock, space-to-depth and pools, attention, the lambda layer, NormConv2d,
   SlimConv2d) and each box op, forward and backward at small shapes, against the
   same on the CPU with the same weights and random draw.
12. ``checks``: each kernel against its plain PyTorch version on the card at the shapes
   the paths gave it, with its time, its plain version's time, the time of one PyTorch
   call computing the same function where there is one (``torch.cdist`` for add2d), and
   its bound: the larger of the bytes it must move over 3.35 TB/s and the operations it
   must do over the card's rate for them. Both routes of the involution forward and
   backward (tiled and general) are checked and timed at the path's shape. The int8
   routes are checked (bit-exact quantization, also on inputs on its ties and beyond
   its clip; exact accumulator; outputs within one ulp) at each int8 layer geometry of
   repvgg_a0 (nine), resnet50 (22) and rexnet1_0x (44) at batch 8 and 32, checked again
   and timed at each at batch 256 (``check_int8_geometry`` lines, device time from CUDA
   graphs): quantize + conv, each kernel, cuDNN's bf16 conv of the layer, the plain
   version, ``torch._int_mm`` on the same int8 operands for each 1x1 stride-1
   geometry (the library call, alone, no epilogue), and the bounds of the route and of
   each kernel. Then a ``rexnet_int8_by_kind`` line sums rexnet1_0x's geometries by
   kind of conv. The grouped general route the same way at resnext101_32x8d's stage-4
   3x3 conv (32 groups of 64, stride 1 and 2; its 16-byte staging), and checked at two
   odd per-group widths (its byte-wise staging): the only launches of
   ``int8_conv_general``, which no serving path runs (its check fails if it launched no
   time).

Each kernel's launch counter is set to 0 just before the path that runs it and read
just after; a kernel that its path never launched fails the run. Then come the
``kernels`` line (the int8 entries over the three serving paths), the card's name and power
limit as ``nvidia-smi`` reports them, and last ``{"ok": true, "device": {...}}``. Each
phase's wall time goes to stderr. Float32 checks run with TF32 off
(``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``).
Any mismatch or error exits non-zero; so does a machine with no CUDA device, or a
directory that holds this script without the package.
"""

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
AGREEMENT_FLOOR = 0.99  # bench.py:150-157
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

# NVIDIA H100 SXM peaks (data sheet, dense): device memory 3.35 TB/s; int8 tensor cores
# 1,979 TOP/s; FP32 on the CUDA cores 67 TFLOP/s, which counts a fused multiply-add as
# two operations: 132 SMs x 128 lanes x 1.98 GHz = 33.45 T FP32 instructions/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_INSTR_PER_S = 132 * 128 * 1.98e9


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall time on stderr (the script's time limit is shared
    by its phases)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    label = " ".join([fn.__name__, *(a for a in args if isinstance(a, str))])
    print(f"chip_smoke: {label} took {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def naturalistic_batch(gen, batch: int, size: int, device):
    """``bench.py:58-69``: bilinear-upsampled noise plus a per-image colour cast,
    standardized per image, channels_last."""
    import torch
    from torch.nn import functional as F

    coarse = torch.randn(batch, 3, size // 8, size // 8, generator=gen, device=device)
    img = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    img = img + 0.5 * torch.randn(batch, 3, 1, 1, generator=gen, device=device)
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    std = img.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return ((img - mean) / (std + 1e-6)).contiguous(memory_format=torch.channels_last)


def reset_counts() -> None:
    from holocron_tpu_torch.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0


def check_logits(out, batch: int, num_classes: int, what: str) -> None:
    import torch

    if tuple(out.shape) != (batch, num_classes) or not bool(torch.isfinite(out).all()):
        fail(f"{what}: expected finite logits of shape {(batch, num_classes)}, got {tuple(out.shape)}")


def phase_build() -> None:
    from holocron_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build(["involution", "int8_conv", "int8_conv_general", "add2d"])
    seconds = time.perf_counter() - t0
    for p in paths:  # the compiler's register / spill report, for the record
        print(p.with_suffix(".log").read_text(), file=sys.stderr)
    emit({"phase": "build", "libraries": [p.name for p in paths], "seconds": round(seconds, 3)})


def phase_serving(device, arch: str = "repvgg_a0", int8_layers: int = 26, wgmma_layers: int = 26,
                  phase: str = "serving", batch: int = 256, size: int = 224, num_classes: int = 10, iters: int = 30):
    """The serving path of ``arch``; a model with ``reparametrize`` (RepVGG) is folded
    into its deploy form, one without (ResNet, ReXNet) is served with BN after each
    conv, as the JAX package serves it. Fails unless ``int8_layers`` convs are int8,
    ``wgmma_layers`` of them on the ``wgmma`` route and the rest on the general route,
    and unless each int8 conv launched the route ``conv_route`` picks for it once a
    forward. The int8 requests run whether or not the gate passes."""
    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.kernels import KERNELS
    from holocron_tpu_torch.kernels.int8_conv import conv_route
    from holocron_tpu_torch.quant import QuantizedConv2d, measure_agreement, quantize_model

    gen = torch.Generator(device=device).manual_seed(SEED)
    model = getattr(models, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                  device=device)
    model = model.to(memory_format=torch.channels_last)

    # BN statistics adapted to the input distribution before folding (bench.py:123-124)
    model.train()
    reparam = {}
    with torch.no_grad():
        for _ in range(4):
            model(naturalistic_batch(gen, batch, size, device))
        model.eval()
        if hasattr(model, "reparametrize"):
            probe = naturalistic_batch(gen, 16, size, device)
            train_eval = model(probe)
            model.reparametrize()
            model = model.to(memory_format=torch.channels_last)
            deploy = model(probe)
            drift = float((train_eval - deploy).abs().max())
            scale = max(1.0, float(train_eval.abs().max()))
            if drift > 1e-3 * scale:  # docs/ARCHITECTURE.md:58
                fail(f"reparametrization drift {drift} > 1e-3 * {scale}")
            reparam["reparam_drift_f32"] = drift

    model_bf16 = copy.deepcopy(model).to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    x = naturalistic_batch(gen, batch, size, device).to(torch.bfloat16)
    # as bench.py: calibrated on the timing batch in float32, float remainder in bf16
    qm = quantize_model(model, calibration_batches=[x.float()], arch=arch).to(torch.bfloat16)
    routes = [conv_route(m.kernel_q.shape[2], m.kernel_q.shape[3], m.groups)
              for m in qm.modules() if isinstance(m, QuantizedConv2d)]
    n_int8, n_wgmma = len(routes), routes.count("wgmma")
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    if (n_int8, n_wgmma) != (int8_layers, wgmma_layers):
        fail(f"{arch}: {n_int8} int8 convs, {n_wgmma} on the wgmma route; expected {int8_layers}, {wgmma_layers}")
    gate_batches = [naturalistic_batch(gen, batch, size, device).to(torch.bfloat16) for _ in range(2)]
    requests = [naturalistic_batch(gen, 8, size, device).to(torch.bfloat16) for _ in range(8)] + [x]
    torch.cuda.synchronize()

    # --- the serving path, counted ---
    reset_counts()
    with torch.no_grad():
        for r in requests:
            check_logits(model_bf16(r), r.shape[0], num_classes, "bf16 deploy")
        agreement = measure_agreement(model_bf16, qm, gate_batches)
        served = agreement["top1_agreement"] >= AGREEMENT_FLOOR
        for r in requests:
            check_logits(qm(r), r.shape[0], num_classes, "int8 deploy")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    # two launches a layer a forward: the quantization and the conv of its route
    forwards = len(gate_batches) + len(requests)
    expected = {"int8_conv": n_wgmma * forwards, "int8_quantize": n_int8 * forwards,
                "int8_conv_general": (n_int8 - n_wgmma) * forwards}
    if any(launches[k] != v for k, v in expected.items()):
        fail(f"{arch}: the int8 path launched {[launches[k] for k in expected]} of {list(expected)}, "
             f"expected {expected}")

    with torch.no_grad():
        ref32 = model(x.float())
        out16 = model_bf16(x).float()
        bf16_vs_f32 = float((out16 - ref32).abs().max())
        bf16_top1_vs_f32 = float((out16.argmax(-1) == ref32.argmax(-1)).float().mean())
        int8_top1_vs_f32 = float((qm(x).argmax(-1) == ref32.argmax(-1)).float().mean())
        bf16_ms = cuda_ms(lambda: model_bf16(x), iters)
        int8_ms = cuda_ms(lambda: qm(x), iters)
        r8 = requests[0]
        bf16_b8_ms = cuda_ms(lambda: model_bf16(r8), iters)
        int8_b8_ms = cuda_ms(lambda: qm(r8), iters)
    torch.cuda.synchronize()
    emit({
        "phase": phase,
        "model": arch,
        "image_size": size,
        "batch": batch,
        **reparam,
        "bf16_vs_f32_max_abs": bf16_vs_f32,
        "bf16_top1_vs_f32": bf16_top1_vs_f32,
        "int8_top1_vs_f32": int8_top1_vs_f32,
        "logit_absmax_f32": float(ref32.abs().max()),
        "int8_convs": n_int8,
        "int8_convs_wgmma": n_wgmma,
        "int8_convs_general": n_int8 - n_wgmma,
        "convs": n_convs,
        "top1_agreement": agreement["top1_agreement"],
        "max_prob_drift": agreement["max_prob_drift"],
        "int8_served": served,
        "served_form": "selective-int8" if served else "bf16",
        # bench.py:162's choice: the faster of bf16 and the int8 form that passed the gate
        "best_form": "selective-int8" if served and int8_ms < bf16_ms else "bf16",
        "bf16_img_per_s": batch / (bf16_ms / 1e3),
        "int8_img_per_s": batch / (int8_ms / 1e3),
        "bf16_batch8_ms": bf16_b8_ms,
        "int8_batch8_ms": int8_b8_ms,
        "launches": launches,
    })
    return qm, model_bf16, x, r8, launches


def phase_serving_profile(qm, model_bf16, x, r8, phase: str = "serving_profile") -> None:
    """The int8 and bf16 forwards under ``torch.profiler`` at batch 256 and 8. Last of
    the timed phases: once the profiler has run, the host launches more slowly."""
    emit({"phase": phase, **{f"{form}_b{xb.shape[0]}": profile_forward(fn, xb)
                             for form, fn in (("int8", qm), ("bf16", model_bf16)) for xb in (x, r8)}})


def profile_forward(fn, x, steps: int = 5, top: int = 10) -> dict:
    """``torch.profiler`` over ``steps`` forwards after warm-up: host wall ms (inflated
    by the profiler itself), summed kernel ms, idle share (1 - kernel / wall) and
    launches per forward, and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(3):
            fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    kernel_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "idle": 1 - kernel_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels) / steps,
            "top": [[e.key[:90], e.device_time_total / 1e3 / steps, e.count / steps] for e in kernels[:top]]}


def phase_involution(device, iters: int = 20):
    import torch

    from holocron_tpu_torch.kernels import KERNELS
    from holocron_tpu_torch.nn import Involution2d

    n, c, hw, g, k = 32, 128, 56, 8, 7
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    module = Involution2d(
        c, k, padding=k // 2, groups=g, reduction_ratio=2, generator=torch.Generator().manual_seed(SEED), device=device
    ).to(torch.bfloat16)
    x = torch.randn(n, c, hw, hw, generator=gen, device=device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    torch.cuda.synchronize()

    reset_counts()
    with torch.no_grad():
        out = module(x)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name].launches for name in ("involution", "involution_general")}
    if launches["involution"] == 0 or launches["involution_general"]:
        fail(f"Involution2d: expected the tiled forward and not the general route's, got {launches}")
    if tuple(out.shape) != (n, c, hw, hw) or not bool(torch.isfinite(out).all()):
        fail(f"Involution2d: expected finite output of shape {(n, c, hw, hw)}, got {tuple(out.shape)}")
    with torch.no_grad():
        module_ms = cuda_ms(lambda: module(x), iters)
    torch.cuda.synchronize()
    emit({"phase": "involution", "shape": [n, c, hw, hw], "groups": g, "kernel_size": k, "dtype": "bfloat16",
          "module_ms": module_ms, "launches": launches})
    return launches


def check_involution(device, iters: int = 20) -> dict:
    """Both forward routes against the plain version at the module's stencil shape, in
    bf16 and float32: each accumulates in float32 in the plain version's tap order with
    separate roundings, so equal, bit for bit."""
    import torch

    from holocron_tpu_torch.kernels import involution as V

    n, h, w, c, g, k = 32, 56, 56, 128, 8, 7
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=device)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=device)
    if V.bwd_route(c, g, torch.bfloat16) != "tiled":
        fail("involution forward: the path's shape does not take the tiled route")
    kernels = {"involution": V.involution_stencil_tiled, "involution_general": V.involution_stencil_general}
    errs = dict.fromkeys(kernels, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        a, b = xp.to(dtype), kern.to(dtype)
        ref = V.involution_stencil_plain(a, b, k, g)
        for name, fn in kernels.items():
            got = fn(a, b, k, g)
            errs[name] = max(errs[name], float((got.float() - ref.float()).abs().max()))
            if not torch.equal(got, ref):
                fail(f"{name} {dtype}: kernel and plain differ (expected bit for bit)")
        del ref, got
    a, b = xp.to(torch.bfloat16), kern.to(torch.bfloat16)
    # xp and kern read once, out written once, bf16; a multiply and an add per (output, tap)
    rec = {"library_ms": None, **bound(2 * (xp.numel() + kern.numel() + n * h * w * c), 2 * n * h * w * c * k * k,
                                       FP32_INSTR_PER_S)}
    rec["plain_ms"] = cuda_ms(lambda: V.involution_stencil_plain(a, b, k, g), max(1, iters // 4), warmup=1)
    records = {name: {**rec, "max_abs_err": errs[name], "ms": cuda_ms(lambda: fn(a, b, k, g), iters)}
               for name, fn in kernels.items()}
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "involution_fwd", "shape": [n, h, w, c, g, k], **records})
    return records


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Mean device time of ``fn`` in ms: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so that host time spent in the
    wrappers between launches does not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (first-launch set-up) outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def tie_and_clip_inputs(device):
    """Activations on which quantization is hard to get right: exactly on the ties
    ``(k + 0.5) * s_x`` (s_x a power of two, so the division is exact), one float32 ulp
    either side of them, at and beyond +-127 * s_x, zeros and signed zeros; and near the
    ties of a scale that is not a power of two."""
    import torch

    cases = []
    s = torch.tensor(2.0**-5, device=device)
    k = torch.arange(-140, 141, device=device, dtype=torch.float32)
    ties = (k + 0.5) * s
    x = torch.cat([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1), k * s,
                   torch.tensor([127.0, -127.0, 127.49, -127.51, 1e6, -1e6, 0.0, -0.0], device=device) * s])
    cases.append((x, s))
    s = torch.tensor(0.0123, device=device)
    cases.append((torch.cat([ties / 2.0**-5 * s, (k + 0.5001) * s, (k + 0.4999) * s]), s))
    out = []
    # shaped (1, 1, L, 1): L is not a multiple of 16, so the kernel's ragged tail runs too
    return [(x.reshape(1, 1, -1, 1), s) for x, s in cases]


def within_ulp(got, ref, ulp: float, what: str) -> float:
    """Fails unless ``got`` is within ``ulp`` relative of the float32 ``ref`` everywhere;
    returns the largest absolute difference."""
    err = (got.float() - ref).abs()
    if bool((err > ref.abs() * ulp).any()):
        fail(f"{what}: output beyond the epilogue's rounding (max {float(err.max())})")
    return float(err.max())


def _int8_case_holds(name, route, xn, s_x, w_q, w_packed, w_scale, bias, stride, padding, dilation, groups,
                     max_err) -> None:
    """One int8 conv on the card against its plain versions: quantized activations
    equal, the int32 accumulator equal, float32 output within one float32 ulp and bf16
    output within one bf16 ulp of the plain epilogue, through ``int8_conv`` and
    ``quantized_conv``. Keeps the largest bf16 error of each route in ``max_err``."""
    import torch

    from holocron_tpu_torch.kernels import int8_conv as K

    x_q = K.quantize_activation(xn, s_x)
    if not torch.equal(x_q, K.quantize_activation_plain(xn, s_x)):
        fail(f"int8_quantize {name}: differs from quantize_activation_plain")
    acc = K.int8_conv_acc(x_q, w_q, stride, padding, dilation, w_packed=w_packed, groups=groups)
    if not torch.equal(acc, K.int8_conv_acc_plain(x_q, w_q, stride, padding, dilation, groups)):
        fail(f"int8 conv {name} ({route}): int32 accumulator differs from the float64 plain conv")
    for dtype, ulp in ((torch.float32, 2.0**-23), (torch.bfloat16, 2.0**-7)):
        ref = K.int8_conv_plain(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, dtype, groups).float()
        outs = [K.int8_conv(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, groups, out_dtype=dtype,
                            w_packed=w_packed),
                K.quantized_conv(xn, s_x, w_q, w_scale, bias, stride, padding, dilation, out_dtype=dtype,
                                 w_packed=w_packed, groups=groups)]
        for got in outs:
            err = within_ulp(got, ref, ulp, f"int8 conv {name} ({route}) {dtype}")
            if dtype == torch.bfloat16:
                max_err[route] = max(max_err[route], err)


def int_mm_ms(x_q, w_packed, o: int, acc, iters: int) -> tuple:
    """``torch._int_mm`` (cuBLASLt's int8 GEMM, int32 out, no epilogue) on a 1x1 stride-1
    conv's operands: x_q at its pitch as an (M, K) int8 matrix and the packed weights'
    first O rows as a column-major (K, N) one, zero-padded to what the call takes (K the
    pitch, a multiple of 16; N = O rounded up to 8, and where cuBLASLt answers
    CUBLAS_STATUS_NOT_SUPPORTED, as it does at some N, K and N rounded up further, to
    32, 64, ...). The padded operands are made outside the timed window, the product
    is checked against the exact accumulator ``acc``. Returns the device time and the
    (M, K, N) timed."""
    import torch

    n, h, w, c = x_q.shape
    pitch = x_q.stride(2)
    m = n * h * w
    x_mat = x_q.as_strided((m, pitch), (pitch, 1))
    for k_mult, n_mult in ((16, 8), (32, 32), (64, 64), (128, 128), (128, 256)):
        k, n_cols = -(-pitch // k_mult) * k_mult, -(-o // n_mult) * n_mult
        a = x_mat if k == pitch else torch.nn.functional.pad(x_mat, (0, k - pitch))
        b = torch.zeros((n_cols, k), dtype=torch.int8, device=x_q.device)
        b[:o, :pitch] = w_packed[:o, :pitch]
        b = b.t()  # column-major (K, N)
        try:
            out = torch._int_mm(a, b)
        except RuntimeError as err:
            if "CUBLAS_STATUS_NOT_SUPPORTED" not in str(err):
                raise
            continue
        if not torch.equal(out[:, :o], acc.reshape(m, o)):
            fail(f"torch._int_mm {(m, k, n_cols)}: differs from the exact accumulator")
        return graph_ms(lambda: torch._int_mm(a, b), iters), [m, k, n_cols]
    fail(f"torch._int_mm: cuBLASLt takes none of the paddings of {(m, pitch, o)}")


def _time_int8_geometry(xin, w_q, w_packed, s_x, w_scale, bias, stride, padding, dilation, groups, cudnn,
                        iters: int) -> dict:
    """At the path's batch: quantized activations and bf16 outputs (of the conv and of
    the route) held against the plain versions, then device time from CUDA graphs of
    the route (quantize + conv), each of its two kernels, ``cudnn`` (cuDNN's bf16 conv of
    the layer), ``torch._int_mm`` on the same int8 operands where the conv is a 1x1
    stride-1 GEMM (its int32 product checked against the accumulator first; the call
    alone, no epilogue) and the plain version, beside the bounds."""
    import torch

    from holocron_tpu_torch.kernels import int8_conv as K

    xn = xin.permute(0, 2, 3, 1)
    kh, kw, c, o = w_q.shape
    route = K.conv_route(c, o, groups)
    args = (s_x, w_scale, bias, stride, padding, dilation, groups)
    x_q = K.quantize_activation(xn, s_x)
    if not torch.equal(x_q, K.quantize_activation_plain(xn, s_x)):
        fail(f"int8_quantize {tuple(xin.shape)} {tuple(w_q.shape)}: differs from quantize_activation_plain")
    y = K.int8_conv(x_q, w_q, *args, out_dtype=torch.bfloat16, w_packed=w_packed)
    y_route = K.quantized_conv(xn, s_x, w_q, *args[1:-1], out_dtype=torch.bfloat16, w_packed=w_packed, groups=groups)
    n, oh, ow, _ = y.shape
    plain = {}

    def run_plain():
        plain["y"] = K.int8_conv_plain(x_q, w_q, *args[:-1], torch.bfloat16, groups)

    gemm = kh == kw == 1 and tuple(stride) == (1, 1) and tuple(padding) == (0, 0) and groups == 1
    with torch.no_grad():
        row = {
            "x": list(xin.shape), "w_hwio": list(w_q.shape), "stride": list(stride), "groups": groups, "route": route,
            "route_ms": graph_ms(lambda: K.quantized_conv(xn, s_x, w_q, *args[1:-1], out_dtype=torch.bfloat16,
                                                          w_packed=w_packed, groups=groups), iters),
            "conv_ms": graph_ms(lambda: K.int8_conv(x_q, w_q, *args, out_dtype=torch.bfloat16, w_packed=w_packed),
                                iters),
            "quantize_ms": graph_ms(lambda: K.quantize_activation(xn, s_x), iters),
            "cudnn_bf16_ms": graph_ms(cudnn, iters),
            "int_mm_ms": None,
            "plain_ms": cuda_ms(run_plain, 2, 1),
            "quantize_plain_ms": cuda_ms(lambda: K.quantize_activation_plain(xn, s_x), 2, 1),
        }
        if gemm:
            acc = K.int8_conv_acc_plain(x_q, w_q, stride, padding, dilation, groups)
            row["int_mm_ms"], row["int_mm_mkn"] = int_mm_ms(x_q, w_packed, o, acc, iters)
    ref = plain["y"].float()
    for what, got in (("int8_conv", y), ("quantized_conv", y_route)):
        within_ulp(got, ref, 2.0**-7, f"{what} {tuple(xin.shape)} {tuple(w_q.shape)} bf16")
    # The conv (either route) reads int8 x once, the int8 weights once and writes bf16 y
    # once; 2 operations per multiply-accumulate. The route (quantize + conv) reads bf16
    # x instead; the prologue alone moves 3 bytes an element.
    macs = n * oh * ow * o * kh * kw * c
    y_bytes = 2 * n * oh * ow * o
    row.update(bound(xin.numel() + w_q.numel() + y_bytes, 2 * macs, INT8_OPS_PER_S))
    row["route_bound_ms"] = bound(2 * xin.numel() + w_q.numel() + y_bytes, 2 * macs, INT8_OPS_PER_S)["bound_ms"]
    row["quantize_bound_ms"] = 3 * xin.numel() / HBM_BYTES_PER_S * 1e3
    row["tops"] = 2 * macs / (row["conv_ms"] * 1e-3) / 1e12
    return row


REXNET_KINDS = ("projections", "expansions", "se_squeezes", "penultimate", "se_excitations")


def rexnet_int8_by_kind(rows: list) -> dict:
    """rexnet1_0x's ``check_int8_geometry`` rows summed by kind of conv (each 1x1):
    projections (6c -> c' on a map), expansions (c -> 6c), the penultimate 185 -> 1280,
    and the SE squeezes and excitations on 1 x 1 maps. ``padded_or_masked``: the 41
    convs with C % 16 != 0 (x at a padded pitch) or O % 8 != 0 (the masked epilogue),
    by kind; ``whole_rows``: the other 3, whose x and y rows are whole 16-byte pieces.
    ``int_mm_ms`` is None where a row has no such time."""

    def kind(row):
        _, _, hw, _ = row["x"]
        _, _, c, o = row["w_hwio"]
        if hw == 1:
            return "se_squeezes" if o < c else "se_excitations"
        return "projections" if o < c else "expansions" if o == 6 * c else "penultimate"

    keys = ("conv_ms", "cudnn_bf16_ms", "int_mm_ms", "bound_ms")
    out = {"padded_or_masked": {k: {"layers": 0, **dict.fromkeys(keys, 0.0)} for k in REXNET_KINDS},
           "whole_rows": {"layers": 0, **dict.fromkeys(keys, 0.0)}}
    for row in rows:
        _, _, c, o = row["w_hwio"]
        rec = out["padded_or_masked"][kind(row)] if c % 16 or o % 8 else out["whole_rows"]
        rec["layers"] += row["count"]
        for k in keys:
            rec[k] = None if rec[k] is None or row.get(k) is None else rec[k] + row["count"] * row[k]
    out["padded_or_masked_total"] = {k: sum(v[k] for v in out["padded_or_masked"].values())
                                     if all(v[k] is not None for v in out["padded_or_masked"].values()) else None
                                     for k in ("layers", *keys)}
    return out


def check_int8(device, qm, model_bf16, x, model: str = "repvgg_a0", iters: int = 20) -> dict:
    """The int8 route against its plain versions at each distinct int8 layer geometry
    of the served ``model`` (inputs captured from it at batch 8 and 32), at a 256 -> 256,
    14x14 layer and at a 3x3 layer of odd widths, 12 -> 20 (``_int8_case_holds``;
    quantization also on inputs built on its ties and beyond its clip). Then each
    geometry at the path's batch of 256 (``_time_int8_geometry``). Per-forward sums
    are kept apart by route (``wgmma``, ``general``); the record returned also holds
    the geometries' rows (``rows``)."""
    import torch
    from torch.nn import functional as F

    from holocron_tpu_torch.kernels import int8_conv as K
    from holocron_tpu_torch.quant import QuantizedConv2d

    layers = [(name, m) for name, m in qm.named_modules() if isinstance(m, QuantizedConv2d)]
    geometries = {}

    def capture(name):
        def hook(module, args):
            key = (tuple(args[0].shape[1:]), tuple(module.kernel_q.shape), module.stride, module.groups)
            rec = geometries.setdefault(key, {"layer": name, "module": module, "count": 0, "x": {}})
            rec["x"][args[0].shape[0]] = args[0]
            if args[0].shape[0] == x.shape[0]:
                rec["count"] += 1

        return hook

    handles = [m.register_forward_pre_hook(capture(name)) for name, m in layers]
    with torch.no_grad():
        qm(x[:8])
        qm(x[:32])
        qm(x)
    for hd in handles:
        hd.remove()
    if sum(g["count"] for g in geometries.values()) != len(layers):
        fail("int8 check: the captured geometries do not cover the int8 layers")

    # -- quantization on ties and clip, float32 and bf16 inputs
    for xin, s in tie_and_clip_inputs(device):
        for dtype in (torch.float32, torch.bfloat16):
            xd = xin.to(dtype)
            if not torch.equal(K.quantize_activation(xd, s), K.quantize_activation_plain(xd, s)):
                fail(f"int8_quantize {dtype}: differs from quantize_activation_plain on the tie/clip inputs")

    # -- correctness at every geometry, the synthetic 256 -> 256 layer and an odd-width one
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    cases = [(f"{key} batch {b}", g["module"].kernel_q, g["module"].kernel_packed, g["module"].w_scale,
              g["module"].act_scale, g["module"].bias, g["module"].stride, g["module"].padding, g["module"].dilation,
              g["module"].groups, g["x"][b]) for key, g in geometries.items() for b in (8, 32)]
    for c, o, hw in ((256, 256, 14), (12, 20, 15)):
        w_q = torch.randint(-127, 128, (3, 3, c, o), generator=gen, device=device, dtype=torch.int8)
        xin = torch.randn(32, c, hw, hw, generator=gen, device=device).to(torch.bfloat16)
        cases.append((f"synthetic {c}->{o} {hw}x{hw}", w_q, None, torch.rand(o, generator=gen, device=device) / 127,
                      xin.abs().amax().float() / 127, torch.randn(o, generator=gen, device=device), (1, 1), (1, 1),
                      (1, 1), 1, xin.contiguous(memory_format=torch.channels_last)))
    max_err = {"wgmma": 0.0, "general": 0.0}
    checked = []
    for name, w_q, w_packed, w_scale, s_x, bias, stride, padding, dilation, groups, xin in cases:
        route = K.conv_route(w_q.shape[2], w_q.shape[3], groups)
        _int8_case_holds(name, route, xin.permute(0, 2, 3, 1), s_x, w_q, w_packed, w_scale, bias, stride, padding,
                         dilation, groups, max_err)
        checked.append({"layer": name, "route": route, "x": list(xin.shape), "w_hwio": list(w_q.shape)})

    # -- checks again and timing at the path's batch
    totals = {"wgmma": {}, "general": {}}
    bound_by = {"wgmma": {}, "general": {}}
    rows = []
    deploy_layers = dict(model_bf16.named_modules())
    for key, g in geometries.items():
        m = g["module"]
        xin = g["x"][x.shape[0]]
        deploy = deploy_layers[g["layer"].removeprefix("model.")]
        row = _time_int8_geometry(
            xin, m.kernel_q, m.kernel_packed, m.act_scale, m.w_scale, m.bias, m.stride, m.padding, m.dilation,
            m.groups, lambda: F.conv2d(xin, deploy.weight, deploy.bias, deploy.stride, deploy.padding, deploy.dilation,
                                       deploy.groups), iters)
        row["count"] = g["count"]
        rows.append(row)
        route = row["route"]
        for k_, v in row.items():
            if k_.endswith("_ms") and v is not None:
                totals[route][k_] = totals[route].get(k_, 0.0) + g["count"] * v
        bound_by[route][row["bound_by"]] = bound_by[route].get(row["bound_by"], 0.0) + g["count"] * row["bound_ms"]
        emit({"phase": "check_int8_geometry", "model": model, **row})
    torch.cuda.synchronize()
    record = {"kernel": "int8_conv", "model": model, "checked": checked, "max_abs_err_bf16": max_err,
              "per_forward": totals, "geometries": len(geometries), "bound_ms_by": bound_by}
    emit({"phase": "check", **record})
    return {**record, "rows": rows}


def check_int8_grouped(device, batch: int = 256, iters: int = 20) -> list:
    """The grouped general route at resnext101_32x8d's stage-4 3x3 conv (32 groups of
    64 channels, 2048 -> 2048, pad 1): the 7 x 7 stride-1 conv and the stride-2 first
    block on 14 x 14, random int8 weights from the seed; checked as ``check_int8``'s
    cases at batch 8, 32 and ``batch``, and timed at ``batch`` beside cuDNN's grouped
    bf16 conv of the same (dequantized) weights. Then the byte-wise staging at odd
    per-group widths (3 groups of 8 -> 5, 5 groups of 3 -> 7 at stride 2; x at a padded
    pitch), checked at batch 8 and 32. No serving path runs the general route, so these
    are its only launches: fails if it launched no time."""
    import torch
    from torch.nn import functional as F

    from holocron_tpu_torch.kernels.int8_conv import KERNEL_GENERAL

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    c, o, groups = 2048, 2048, 32
    w_q = torch.randint(-127, 128, (3, 3, c // groups, o), generator=gen, device=device, dtype=torch.int8)
    w_scale = torch.rand(o, generator=gen, device=device) / 127 / 64
    bias = torch.randn(o, generator=gen, device=device).to(torch.bfloat16)
    weight = (w_q.float() * w_scale).permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    max_err = {"wgmma": 0.0, "general": 0.0}
    rows = []
    before = KERNEL_GENERAL.launches
    odd = torch.Generator(device=device).manual_seed(SEED + 12)
    for hw, oc, oo, og, stride in ((9, 24, 15, 3, 1), (6, 15, 35, 5, 2)):
        ow_q = torch.randint(-127, 128, (3, 3, oc // og, oo), generator=odd, device=device, dtype=torch.int8)
        ox = torch.randn(32, hw, hw, oc, generator=odd, device=device).to(torch.bfloat16)
        ow_scale = torch.rand(oo, generator=odd, device=device) / 127
        obias = torch.randn(oo, generator=odd, device=device)
        for b in (8, 32):
            _int8_case_holds(f"grouped {oc}/{og} -> {oo} {hw}x{hw} s{stride} batch {b}", "general", ox[:b],
                             ox.float().abs().amax() / 127, ow_q, None, ow_scale, obias, (stride, stride), (1, 1),
                             (1, 1), og, max_err)
    for hw, stride in ((7, 1), (14, 2)):
        x = torch.randn(batch, c, hw, hw, generator=gen, device=device).relu().to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        s_x = x.float().abs().amax() / 127
        for b in (8, 32, batch):
            _int8_case_holds(f"grouped {c}/{groups} {hw}x{hw} s{stride} batch {b}", "general",
                             x[:b].permute(0, 2, 3, 1), s_x, w_q, None, w_scale, bias, (stride, stride), (1, 1), (1, 1),
                             groups, max_err)
        row = _time_int8_geometry(x, w_q, None, s_x, w_scale, bias, (stride, stride), (1, 1), (1, 1), groups,
                                  lambda: F.conv2d(x, weight, bias, stride, 1, 1, groups), iters)
        row["max_abs_err_bf16"] = max_err["general"]
        emit({"phase": "check_int8_geometry", "model": "resnext101_32x8d", **row})
        rows.append(row)
        del x
    torch.cuda.synchronize()
    if KERNEL_GENERAL.launches == before:
        fail("int8_conv_general: the grouped check never launched it")
    return rows


def synthetic_batches(gen, count: int, batch: int, size: int, num_classes: int, device):
    """Random uint8 NCHW images (channels_last) and labels, made on the device from a
    seed: the counterpart of the JAX package's ``SyntheticDataset``."""
    import torch

    return [
        (torch.randint(0, 256, (batch, 3, size, size), generator=gen, device=device, dtype=torch.uint8)
         .contiguous(memory_format=torch.channels_last),
         torch.randint(0, num_classes, (batch,), generator=gen, device=device))
        for _ in range(count)
    ]


def make_trainer(device, train, val, num_classes: int, arch: str = "repvgg_a0", **kwargs):
    """The classification reference's trainer (references/classification/train.py:204-302)
    around a fresh ``arch`` with weights from the seed."""
    import functools

    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.nn.functional import multilabel_cross_entropy
    from holocron_tpu_torch.optim import LAMB
    from holocron_tpu_torch.trainer import ClassificationTrainer

    def criterion(out, target):  # label smoothing 0.1 on one-hot targets (train.py:246-250)
        onehot = torch.nn.functional.one_hot(target, num_classes).to(out.dtype)
        return multilabel_cross_entropy(out, onehot * 0.9 + 0.1 / num_classes)

    model = getattr(models, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                  device=device)
    model = model.to(memory_format=torch.channels_last)
    return ClassificationTrainer(
        model, train, val, criterion, functools.partial(LAMB, weight_decay=5e-5), device=device,
        output_file=str(ROOT / "holocron_tpu_torch" / "_build" / "smoke_checkpoint.pt"), amp=True,
        skip_nan_loss=True, gradient_acc=2, gradient_clip=1.0, input_norm=IMAGENET, **kwargs,
    )


def fit_one_epoch(trainer, what: str) -> tuple:
    """``fit_n_epochs(1, 1e-3)`` (``gradient_acc=2``: an update every 2 batches), then
    ``evaluate()``, with each batch's loss kept by wrapping the step. Fails unless every
    loss and the validation loss are finite and every update was applied. Returns the
    losses and the eval metrics."""
    evaluated, losses = [], []
    run_step = trainer._run_step_async

    def recorded_step(x, y):
        losses.append(run_step(x, y))
        return losses[-1]

    trainer.on_epoch_end = evaluated.append
    trainer._run_step_async = recorded_step
    trainer.fit_n_epochs(1, 1e-3)
    trainer._run_step_async = run_step
    losses = [float(v) for v in losses]
    metrics = evaluated[0]
    n = len(trainer.train_loader)
    if len(losses) != n or not all(map(math.isfinite, losses)) or not math.isfinite(metrics["val_loss"]):
        fail(f"{what}: expected {n} finite losses and a finite val_loss, got {losses} and {metrics}")
    if trainer._opt.param_groups[0]["count"] != n // 2:
        fail(f"{what}: expected {n // 2} applied updates, got {trainer._opt.param_groups[0]['count']}")
    return losses, metrics


def time_train_steps(trainer, batches, steps: int) -> float:
    """Mean ms of a train step over a steady window of ``steps``, after 2 more; CUDA
    events around them."""
    import torch

    run_step = trainer._run_step_async
    for _ in range(2):
        run_step(*batches[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(steps):
        run_step(*batches[i % len(batches)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def phase_training(device, batch: int = 128, size: int = 224, num_classes: int = 10, timed_steps: int = 6):
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    train = synthetic_batches(gen, 8, batch, size, num_classes, device)
    val = synthetic_batches(gen, 2, batch, size, num_classes, device)
    trainer = make_trainer(device, train, val, num_classes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # one epoch (4 applied updates), then evaluate() on 2 batches; then a steady window
    losses, metrics = fit_one_epoch(trainer, "training")
    step_ms = time_train_steps(trainer, train, timed_steps)
    peak_bytes = torch.cuda.max_memory_allocated()
    run_step = trainer._run_step_async
    y = train[0][1]

    # a float32 batch holding a NaN (float batches bypass input_norm): the update is
    # skipped; last, since its BN statistics are NaN from here on (core.py:496-503)
    params = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    head = trainer.model.head.weight
    moments = trainer._opt.state[head]["exp_avg"].clone(), trainer._opt.state[head]["exp_avg_sq"].clone()
    count, skipped = trainer._opt.param_groups[0]["count"], trainer.skipped_steps
    x_nan = torch.randn(batch, 3, size, size, generator=gen, device=device).contiguous(memory_format=torch.channels_last)
    x_nan[0, 0, 0, 0] = float("nan")
    nan_loss = float(run_step(x_nan, y))
    kept = all(torch.equal(v, dict(trainer.model.named_parameters())[k]) for k, v in params.items())
    kept = kept and torch.equal(moments[0], trainer._opt.state[head]["exp_avg"])
    kept = kept and torch.equal(moments[1], trainer._opt.state[head]["exp_avg_sq"])
    if not (math.isnan(nan_loss) and kept and trainer._opt.param_groups[0]["count"] == count
            and trainer.skipped_steps == skipped + 1):
        fail("training: the non-finite step was not skipped (params, moments or count changed)")
    params_f32 = all(p.dtype == torch.float32 for p in trainer.model.parameters())
    if not params_f32:
        fail("training: amp left master params in another dtype than float32")

    fresh = make_trainer(device, train[:1], val, num_classes)
    setup = fresh.check_setup(lr=1e-3, num_it=10)
    if not setup[-1] < setup[0]:
        fail(f"training: check_setup loss did not fall: {setup}")
    profile = summarize_profile(fresh.profile(num_steps=4), 4)
    torch.cuda.synchronize()
    emit({"phase": "training", "model": "repvgg_a0", "image_size": size, "batch": batch, "amp": True,
          "gradient_acc": 2, "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
          "skipped_steps": trainer.skipped_steps, **metrics, "train_step_ms": step_ms,
          "train_img_per_s": batch / (step_ms / 1e3), "peak_memory_gib": peak_bytes / 2**30,
          "params_f32": params_f32, "check_setup_first": setup[0], "check_setup_last": setup[-1]})
    emit({"phase": "training_profile", **profile})


def phase_arch_training(device, arch: str = "resnet50", phase: str = "resnet_training", batch: int = 128,
                        size: int = 224, num_classes: int = 10, timed_steps: int = 4):
    """``arch`` in the trainer of ``phase_training``, with the same settings: one epoch
    of 4 batches (2 updates) and ``evaluate()`` on one, then a steady window."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    train = synthetic_batches(gen, 4, batch, size, num_classes, device)
    val = synthetic_batches(gen, 1, batch, size, num_classes, device)
    trainer = make_trainer(device, train, val, num_classes, arch=arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, metrics = fit_one_epoch(trainer, f"{arch} training")
    step_ms = time_train_steps(trainer, train, timed_steps)
    peak_bytes = torch.cuda.max_memory_allocated()
    params_f32 = all(p.dtype == torch.float32 for p in trainer.model.parameters())
    if not params_f32:
        fail(f"{arch} training: amp left master params in another dtype than float32")
    torch.cuda.synchronize()
    emit({"phase": phase, "model": arch, "image_size": size, "batch": batch, "amp": True,
          "gradient_acc": 2, "loss_first": losses[0], "loss_last": losses[-1], "losses": losses, **metrics,
          "train_step_ms": step_ms, "train_img_per_s": batch / (step_ms / 1e3), "peak_memory_gib": peak_bytes / 2**30,
          "params_f32": params_f32, "params": sum(p.numel() for p in trainer.model.parameters())})


ZOO = ("resnet50d", "resnext50_32x4d", "res2net50_26w_4s", "sknet50", "tridentnet50", "pyconv_resnet50",
       "pyconvhg_resnet50")


def phase_resnet_zoo(device, batch: int = 32, size: int = 224, num_classes: int = 10, iters: int = 10) -> None:
    """One eval forward of each other family of the ResNet container at full width, in
    float32 and bf16 (channels_last, default BN statistics, random weights from the
    seed): cuDNN's grouped, dilated and pyramidal convs at their real widths. Fails on
    logits that are not finite. cuDNN picks its algorithms by its heuristics here
    (``cudnn.benchmark`` off): autotuning each new shape of seven models in two dtypes
    took most of the phase's time, and these forwards are host-bound at batch 32."""
    import torch

    from holocron_tpu_torch import models

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    x = naturalistic_batch(gen, batch, size, device)
    x16 = x.to(torch.bfloat16)
    rows = {}
    benchmark, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, False
    try:
        for arch in ZOO:
            model = getattr(models, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                          device=device)
            model = model.to(memory_format=torch.channels_last).eval()
            with torch.no_grad():
                ref = model(x)
                check_logits(ref, batch, num_classes, f"{arch} float32")
                model = model.to(torch.bfloat16)
                out = model(x16)
                check_logits(out, batch, num_classes, f"{arch} bf16")
                ms = cuda_ms(lambda: model(x16), iters)
            rows[arch] = {"params": sum(p.numel() for p in model.parameters()),
                          "bf16_vs_f32_max_abs": float((out.float() - ref).abs().max()),
                          "logit_absmax_f32": float(ref.abs().max()),
                          "bf16_top1_vs_f32": float((out.argmax(-1) == ref.argmax(-1)).float().mean()),
                          "bf16_ms": ms, "bf16_img_per_s": batch / (ms / 1e3)}
            del model, ref, out
    finally:
        torch.backends.cudnn.benchmark = benchmark
    torch.cuda.synchronize()
    emit({"phase": "resnet_zoo", "image_size": size, "batch": batch, "models": rows})


CATALOG_TOL = 1e-4


def phase_nn_catalog(device) -> dict:
    """Each module and function of the nn catalog and each box op, forward and backward
    once on the card at small shapes, against the same on the CPU with the same weights
    (built on the CPU from the seed, then copied) and the same random draw (DropBlock's
    block centers, the mutual-channel loss's channel masks, drawn on the CPU): outputs,
    the input's gradients and the BN statistics within ``CATALOG_TOL`` of each tensor's
    largest magnitude plus ``CATALOG_TOL`` relative, the parameters' gradients against
    the module's largest gradient (the card sums in other orders; TF32 is off). A
    mismatch fails the run."""
    import torch

    from holocron_tpu_torch import nn, ops
    from holocron_tpu_torch.nn import functional as HF

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 12)
    errs = {}

    def close(name, got, ref, scale=None):
        got, ref = got.detach().float().cpu(), ref.detach().float()
        if scale is None:
            scale = float(ref.abs().max()) if ref.numel() else 0.0
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        if tuple(got.shape) != tuple(ref.shape) or not bool(((got - ref).abs() <= CATALOG_TOL * (scale + ref.abs()))
                                                            .all()):
            fail(f"nn_catalog {name}: the card and the CPU differ (max {err} at scale {scale})")
        errs[name] = max(errs.get(name, 0.0), err / max(scale, 1e-30))

    def run(module, fn, inputs):
        """``fn(module, *inputs)`` and the gradients of ``sum(out * w)``."""
        inputs = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
        out = fn(module, *inputs)
        w = torch.linspace(-1.0, 1.0, out.numel(), device=out.device).reshape(out.shape)
        (out * w).sum().backward()
        grads = [t.grad for t in inputs if t.grad is not None]
        return out, grads

    def compare(name, module, fn, *inputs, train=True):
        if module is not None:
            module.zero_grad(set_to_none=True)
        card = copy.deepcopy(module).to(device) if module is not None else None
        for m in (module, card):
            if m is not None:
                m.train(train)
        out_c, g_c = run(module, fn, inputs)
        out_d, g_d = run(card, fn, [t.to(device) for t in inputs])
        close(name, out_d, out_c)
        for i, (a, b) in enumerate(zip(g_d, g_c)):
            close(f"{name} input grad {i}", a, b)
        if module is not None:
            # against the module's largest gradient: a bias that a train-mode norm follows
            # has a zero gradient in exact arithmetic, rounding noise on either device
            params_d = dict(card.named_parameters())
            scale = max((float(p.grad.abs().max()) for p in module.parameters()), default=0.0)
            for pname, p in module.named_parameters():
                close(f"{name} grad {pname}", params_d[pname].grad, p.grad, scale)
            buffers_d = dict(card.named_buffers())
            for bname, b in module.named_buffers():
                if bname.endswith(("running_mean", "running_var")):
                    close(f"{name} {bname}", buffers_d[bname], b)

    x = torch.randn(2, 8, 6, 7, generator=gen)
    modules = {
        "FReLU": nn.FReLU(8, device=cpu, generator=gen),
        "SAM": nn.SAM(8, device=cpu, generator=gen),
        "TripletAttention": nn.TripletAttention(device=cpu, generator=gen),
        "LambdaLayer_r": nn.LambdaLayer(8, 8, 4, r=3, num_heads=2, dim_u=2, device=cpu, generator=gen),
        "LambdaLayer_n": nn.LambdaLayer(8, 12, 4, n=42, num_heads=3, dim_u=2, device=cpu, generator=gen),
        "NormConv2d": nn.NormConv2d(8, 6, 3, stride=2, padding=1, eps=1e-5, device=cpu, generator=gen),
        "SlimConv2d": nn.SlimConv2d(8, 3, padding=1, r=2, device=cpu, generator=gen),
        "HardMish": nn.HardMish(),
        "NLReLU": nn.NLReLU(0.5),
        "ConcatDownsample2d": nn.ConcatDownsample2d(2),
        "GlobalMaxPool2d": nn.GlobalMaxPool2d(True),
        "SPP": nn.SPP((3, 5)),
        "ZPool": nn.ZPool(),
    }
    for name, module in modules.items():
        xin = x[:, :, :, :6] if name == "ConcatDownsample2d" else x
        compare(name, module, lambda m, t: m(t), xin)
        if any(True for _ in module.parameters()):
            compare(f"{name} eval", module, lambda m, t: m(t), xin, train=False)

    # DropBlock: its draw on the CPU, then the part after it; the module's own draw on the card
    centers = torch.rand(2, 6, 7, generator=gen) <= 0.2
    compare("dropblock2d", None, lambda _, t, c: HF.dropblock2d_from_centers(t, c, 3),
            x.permute(0, 2, 3, 1), centers)
    drop = nn.DropBlock2d(0.5, 3, generator=torch.Generator(device=device).manual_seed(SEED)).train()
    out = drop(x.to(device))
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        fail("nn_catalog DropBlock2d: expected a finite output of the input's shape on the card")

    # losses (channel-last logits), the mutual-channel loss on masks drawn on the CPU
    logits = torch.randn(4, 3, 2, 5, generator=gen)
    target = torch.randint(0, 5, (4, 3, 2), generator=gen)
    soft = torch.softmax(torch.randn(4, 3, 2, 5, generator=gen), -1)
    weight = torch.rand(5, generator=gen) + 0.5
    losses = {
        "FocalLoss": (nn.FocalLoss(weight=weight, ignore_index=2, device=cpu), target),
        "ComplementCrossEntropy": (nn.ComplementCrossEntropy(weight=weight, reduction="sum", device=cpu), target),
        "PolyLoss": (nn.PolyLoss(weight=weight, reduction="none", device=cpu), target),
        "PolyLoss_soft": (nn.PolyLoss(eps=1.0, device=cpu), soft),
        "MultiLabelCrossEntropy": (nn.MultiLabelCrossEntropy(weight=weight, device=cpu), soft),
        "ClassBalancedWrapper": (nn.ClassBalancedWrapper(nn.FocalLoss(device=cpu), [10, 20, 5, 40, 8], device=cpu),
                                 target),
        "DiceLoss": (nn.DiceLoss(weight=weight, gamma=0.5, device=cpu), soft),
    }
    for name, (loss, tgt) in losses.items():
        compare(name, loss, lambda m, t, y: m(t, y), logits, tgt)
    mask = torch.stack([torch.randperm(2, generator=gen) < 1 for _ in range(5)]).float()
    compare("mutual_channel_loss", None,
            lambda _, t, y, mk: HF.mutual_channel_loss_masked(t, y, mk, None, -100, "mean", 2, 0.7),
            torch.randn(4, 3, 2, 10, generator=gen), target, mask)

    # box ops on overlapping, nested, disjoint and touching boxes
    b1 = torch.tensor([[0, 0, 4, 4], [1, 1, 3, 5], [0, 0, 10, 1], [5, 5, 6, 7]], dtype=torch.float32)
    b2 = torch.tensor([[0, 0, 4, 4], [2, 1, 6, 3], [4, 0, 8, 4], [0.5, 0.5, 9, 2], [10, 10, 12, 13]])
    for name in ("box_iou", "box_giou", "iou_penalty", "diou_loss", "aspect_ratio_consistency", "ciou_loss"):
        compare(name, None, lambda _, a, b, fn=getattr(ops, name): fn(a, b), b1, b2)
    torch.cuda.synchronize()
    record = {"phase": "nn_catalog", "tolerance": CATALOG_TOL, "checks": len(errs),
              "max_rel_err": max(errs.values()), "worst": max(errs, key=errs.get)}
    emit(record)
    return record


def step_kernel_ms(step, steps: int = 5) -> float:
    """The summed device time of the kernels one call of ``step`` launches, from
    ``torch.profiler`` over ``steps`` calls after warm-up: the step's time on the card,
    whatever time the host adds between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3 / steps


def summarize_profile(prof, steps: int, top: int = 12) -> dict:
    """Per step: the host time of the train step's ranges (``train_step.*``), the device
    span of each range and of ``LAMB.step`` (first to last kernel under it), the summed
    kernel time, the device's idle share (1 - kernel time / host time of the step), and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType

    def annotation(e) -> bool:
        return bool(getattr(e, "is_user_annotation", False)) or e.key.startswith(("train_step.", "Optimizer."))

    events = prof.key_averages()
    host = {e.key.split(".")[-1]: e.cpu_time_total / 1e3 / steps
            for e in events if e.device_type == DeviceType.CPU and e.key.startswith("train_step.")}
    spans = {e.key: e.device_time_total / 1e3 / steps
             for e in events if e.device_type == DeviceType.CUDA and annotation(e)}
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA and not annotation(e)),
                     key=lambda e: -e.device_time_total)
    kernel_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    step_host_ms = sum(host.values())
    return {
        "steps": steps,
        "host_ms": host,
        "device_span_ms": spans,
        "step_host_ms": step_host_ms,
        "kernel_ms": kernel_ms,
        "idle": 1 - kernel_ms / step_host_ms if step_host_ms else None,
        "kernel_launches": sum(e.count for e in kernels) / steps,
        "top": [[e.key[:90], e.device_time_total / 1e3 / steps, e.count / steps] for e in kernels[:top]],
    }


def phase_involution_train(device, n: int = 32, hw: int = 56, iters: int = 10) -> dict:
    import torch

    from holocron_tpu_torch.kernels import KERNELS
    from holocron_tpu_torch.nn import Involution2d

    c, g, k = 128, 8, 7
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    module = Involution2d(
        c, k, padding=k // 2, groups=g, reduction_ratio=2, generator=torch.Generator().manual_seed(SEED), device=device
    ).to(torch.bfloat16)
    x = torch.randn(n, c, hw, hw, generator=gen, device=device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    gy = torch.randn(n, c, hw, hw, generator=gen, device=device).to(torch.bfloat16)
    torch.cuda.synchronize()

    names = ("involution", "involution_bwd_dxp", "involution_bwd_dkern")
    general = ("involution_general", "involution_bwd_dxp_general", "involution_bwd_dkern_general")
    reset_counts()
    module(x).backward(gy)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name].launches for name in names + general}
    if not all(launches[name] for name in names) or any(launches[name] for name in general):
        fail(f"Involution2d training: expected the forward and the tiled backward kernels, not the general "
             f"route's, got {launches}")
    grads = {"x": x.grad, "reduce.weight": module.reduce.weight.grad, "span.weight": module.span.weight.grad}
    if not all(gr is not None and bool(torch.isfinite(gr).all()) and bool(gr.abs().sum() > 0) for gr in grads.values()):
        fail("Involution2d training: a gradient is missing, zero or not finite")

    def step():
        x.grad = None
        module.zero_grad(set_to_none=True)
        module(x).backward(gy)

    ms = cuda_ms(step, iters)
    kernel_ms = step_kernel_ms(step)
    torch.cuda.synchronize()
    emit({"phase": "involution_train", "shape": [n, c, hw, hw], "groups": g, "kernel_size": k, "dtype": "bfloat16",
          "fwd_bwd_ms": ms, "fwd_bwd_kernel_ms": kernel_ms, "launches": launches})
    return launches


def phase_add2d(device, n: int = 4, hw: int = 56, iters: int = 10) -> dict:
    import torch

    from holocron_tpu_torch.kernels import KERNELS
    from holocron_tpu_torch.nn import Add2d

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    module = Add2d(64, 128, 3, padding=1, generator=torch.Generator().manual_seed(SEED), device=device)
    x = torch.randn(n, 64, hw, hw, generator=gen, device=device).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    gy = torch.randn(n, 128, hw, hw, generator=gen, device=device)
    torch.cuda.synchronize()

    names = ("add2d_fwd", "add2d_bwd_dp", "add2d_bwd_dw")
    reset_counts()
    out = module(x)
    out.backward(gy)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name].launches for name in names}
    if not all(launches.values()):
        fail(f"Add2d never launched some of its kernels: {launches}")
    if tuple(out.shape) != (n, 128, hw, hw) or not bool(torch.isfinite(out).all()):
        fail(f"Add2d: expected finite output of shape {(n, 128, hw, hw)}, got {tuple(out.shape)}")
    if not all(bool(torch.isfinite(t).all()) for t in (x.grad, module.weight.grad, module.bias.grad)):
        fail("Add2d: a gradient is not finite")

    def step():
        x.grad = None
        module.zero_grad(set_to_none=True)
        module(x).backward(gy)

    ms = cuda_ms(step, iters)
    kernel_ms = step_kernel_ms(step)
    torch.cuda.synchronize()
    emit({"phase": "add2d", "shape": [n, 64, hw, hw], "out_channels": 128, "dtype": "float32", "fwd_bwd_ms": ms,
          "fwd_bwd_kernel_ms": kernel_ms, "launches": launches})
    return launches


def _excess(got, ref, allowed) -> float:
    """The largest amount by which |got - ref| exceeds its allowed error (<= 0 passes)."""
    return float(((got.float() - ref.float()).abs() - allowed).max())


def check_involution_bwd(device, n: int = 32, hw: int = 56, iters: int = 20) -> dict:
    """Both backward kernels of both routes against their plain versions at the module's
    shapes; the path takes the tiled route, and the general route's public functions
    are called directly. dxp: each kernel adds in the plain version's tap order with
    separate roundings, so equal to plain, bit for bit. dkern: each group's cg = 16
    products are summed in another order (tiled: four partial sums of fused
    multiply-adds; general: a warp butterfly), so within 1e-5 of the sum of their
    absolute values, plus one bf16 rounding of each side in bf16."""
    import torch

    from holocron_tpu_torch.kernels import involution as V

    h, w, c, g, k = hw, hw, 128, 8, 7
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=device)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=device)
    gout = torch.randn(n, h, w, c, generator=gen, device=device)
    if V.bwd_route(c, g, torch.bfloat16) != "tiled":
        fail("involution backward: the path's shape does not take the tiled route")
    kernels = {"involution_bwd_dxp": (V.involution_bwd_dxp, V.involution_bwd_dxp_plain),
               "involution_bwd_dkern": (V.involution_bwd_dkern, V.involution_bwd_dkern_plain),
               "involution_bwd_dxp_general": (V.involution_bwd_dxp_general, V.involution_bwd_dxp_plain),
               "involution_bwd_dkern_general": (V.involution_bwd_dkern_general, V.involution_bwd_dkern_plain)}
    errs = dict.fromkeys(kernels, 0.0)
    for dtype, ulp in ((torch.bfloat16, 2.0**-7), (torch.float32, 0.0)):
        a, b, gg = xp.to(dtype), kern.to(dtype), gout.to(dtype)
        refs = {"dxp": V.involution_bwd_dxp_plain(a, b, gg, k, g), "dkern": V.involution_bwd_dkern_plain(a, b, gg, k, g)}
        absterms = V.involution_bwd_dkern_plain(a.float().abs(), b.float(), gg.float().abs(), k, g)
        for name, (fn, _) in kernels.items():
            got = fn(a, b, gg, k, g)
            if "dxp" in name:
                ref = refs["dxp"]
                if not torch.equal(got, ref):
                    fail(f"{name} {dtype}: kernel and plain differ (expected bit for bit)")
            else:
                ref = refs["dkern"]
                if _excess(got, ref, 1e-5 * absterms + ulp * ref.float().abs()) > 0:
                    fail(f"{name} {dtype}: kernel and plain differ beyond the stated tolerance")
            errs[name] = max(errs[name], float((got.float() - ref.float()).abs().max()))
            del got
        del refs, absterms
    a, b, gg = xp.to(torch.bfloat16), kern.to(torch.bfloat16), gout.to(torch.bfloat16)
    records = {}
    ops = 2 * n * h * w * c * k * k  # a multiply and an add per (output element, tap)
    # each reads two of xp, kern and g once and writes the third's shape once, bf16
    nbytes = 2 * (a.numel() + b.numel() + gg.numel())
    for name, (fn, plain) in kernels.items():
        ms = cuda_ms(lambda: fn(a, b, gg, k, g), iters)
        plain_ms = cuda_ms(lambda: plain(a, b, gg, k, g), max(1, iters // 4), warmup=1)
        records[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         **bound(nbytes, ops, FP32_INSTR_PER_S)}
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "involution_bwd", "shape": [n, h, w, c, g, k], **records})
    return records


def check_add2d(device, l: int = 12544, d: int = 576, o: int = 128, iters: int = 20) -> dict:
    """The three add2d kernels against their plain versions at the layer's shape, float32.
    Forward: a sum of D non-negative terms added in another order, rtol 1e-4 (D * 2^-24
    is 3.4e-5). Gradients: signed sums of +-g over O (dp) or L (dw), whose rounding grows
    like sqrt(n) * 2^-24 * sum |g| (7e-6 at n = 12544): within 2e-5 * sum |g| over the
    reduced axis. Library: ``-torch.cdist(p, w.T, p=1)`` and its autograd backward (which
    gives dp and dw together)."""
    import torch

    from holocron_tpu_torch.kernels import add2d as A

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    p, w, gg = (torch.randn(*s, generator=gen, device=device) for s in ((l, d), (d, o), (l, o)))
    gabs = gg.abs()
    checks = (
        ("add2d_fwd", lambda: A.add2d_matmul(p, w), lambda: A.add2d_matmul_plain(p, w), lambda ref: 1e-4 * ref.abs()),
        ("add2d_bwd_dp", lambda: A.add2d_bwd_dp(p, w, gg), lambda: A.add2d_bwd_dp_plain(p, w, gg),
         lambda ref: 2e-5 * gabs.sum(1, keepdim=True)),
        ("add2d_bwd_dw", lambda: A.add2d_bwd_dw(p, w, gg), lambda: A.add2d_bwd_dw_plain(p, w, gg),
         lambda ref: 2e-5 * gabs.sum(0, keepdim=True)),
    )
    steps = l * d * o
    # instructions per element step: sub + add|abs (forward); sub, sign select, fma (gradients)
    instr = {"add2d_fwd": 2, "add2d_bwd_dp": 3, "add2d_bwd_dw": 3}
    nbytes = {"add2d_fwd": 4 * (l * d + d * o + l * o), "add2d_bwd_dp": 4 * (l * d + d * o + l * o + l * d),
              "add2d_bwd_dw": 4 * (l * d + d * o + l * o + d * o)}
    records = {}
    for name, kernel, plain, allowed in checks:
        got, ref = kernel(), plain()
        if _excess(got, ref, allowed(ref)) > 0:
            fail(f"{name}: kernel and plain differ beyond the stated tolerance (max {float((got - ref).abs().max())})")
        records[name] = {"max_abs_err": float((got - ref).abs().max()), "ms": cuda_ms(kernel, iters),
                         "plain_ms": cuda_ms(plain, 2, warmup=1), **bound(nbytes[name], instr[name] * steps,
                                                                         FP32_INSTR_PER_S)}
    for name, kernel, _, _ in checks:
        if not torch.equal(kernel(), kernel()):
            fail(f"{name}: two runs on the same inputs differ")
    pl, wl = p.clone().requires_grad_(), w.clone().requires_grad_()
    with torch.no_grad():
        lib = -torch.cdist(p, w.T, p=1)
    if _excess(lib, A.add2d_matmul_plain(p, w), 1e-4 * lib.abs()) > 0:
        fail("torch.cdist does not compute the add2d forward at the stated tolerance")
    with torch.no_grad():
        records["add2d_fwd"]["library_ms"] = cuda_ms(lambda: -torch.cdist(p, w.T, p=1), iters)
    out = -torch.cdist(pl, wl.T, p=1)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (pl, wl), gg, retain_graph=True), max(1, iters // 4), warmup=1)
    records["add2d_bwd_dp"]["library_ms"] = records["add2d_bwd_dw"]["library_ms"] = bwd_ms
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "add2d", "shape": [l, d, o], **records})
    return records


def int8_entries(launches: list, records: list, grouped: list) -> list:
    """The ``kernels`` line's entries of the int8 kernels, over the serving paths
    (repvgg_a0's, resnet50's and rexnet1_0x's): launches summed over the paths' runs;
    the wgmma conv's and the quantization's times and bounds summed over one batch-256
    forward of each model (each geometry times its count of layers; each conv's bound
    counts the int8 x it reads). No path runs the general route (0 launches): its times
    are those of the grouped check (``grouped``: resnext101_32x8d's two stage-4 convs,
    summed). ``library_ms`` is None: ``torch._int_mm`` computes only the 1x1 stride-1
    convs (``check_int8_geometry``'s ``int_mm_ms``), not the 3x3 ones of repvgg_a0 and
    resnet50."""

    def total(key, route=None):
        return sum(v for r in records for rt, t in r["per_forward"].items() if route in (None, rt)
                   for k, v in t.items() if k == key)

    by = {}
    for r in records:
        for k, v in r["bound_ms_by"]["wgmma"].items():
            by[k] = by.get(k, 0.0) + v
    src = "holocron_tpu_torch/csrc/"

    def entry(name, source, ms, plain_ms, bound_ms, bound_by, max_abs_err):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": "holocron_tpu/quant.py:259",
                "launches": sum(run[name] for run in launches), "max_abs_err": max_abs_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

    quantize = entry("int8_quantize", "int8_conv.cu", total("quantize_ms"), total("quantize_plain_ms"),
                     total("quantize_bound_ms"), "bytes", 0.0)
    quantize["replaces"] = "holocron_tpu/quant.py:244"
    return [
        entry("int8_conv", "int8_conv.cu", total("conv_ms", "wgmma"), total("plain_ms", "wgmma"),
              total("bound_ms", "wgmma"), max(by, key=by.get), max(r["max_abs_err_bf16"]["wgmma"] for r in records)),
        quantize,
        entry("int8_conv_general", "int8_conv_general.cu", sum(g["conv_ms"] for g in grouped),
              sum(g["plain_ms"] for g in grouped), sum(g["bound_ms"] for g in grouped),
              max(grouped, key=lambda g: g["bound_ms"])["bound_by"], max(g["max_abs_err_bf16"] for g in grouped)),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs the port on an NVIDIA GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "holocron_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: holocron_tpu_torch not found beside {Path(__file__).name}; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # float32 checks (reparametrization drift, involution f32) need full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    timed(phase_build)
    qm, model_bf16, x, r8, serving_launches = timed(phase_serving, device)
    rqm, rmodel_bf16, rx, rr8, resnet_launches = timed(phase_serving, device, "resnet50", 52, 52, "resnet_serving")
    xqm, xmodel_bf16, xx, xr8, rexnet_launches = timed(phase_serving, device, "rexnet1_0x", 44, 44, "rexnet_serving")
    inv_launches = timed(phase_involution, device)
    timed(phase_training, device)
    timed(phase_arch_training, device)
    timed(phase_arch_training, device, "rexnet1_0x", "rexnet_training")
    inv_train = timed(phase_involution_train, device)
    add2d_launches = timed(phase_add2d, device)
    timed(phase_resnet_zoo, device)
    timed(phase_nn_catalog, device)
    inv = timed(check_involution, device)
    inv_bwd = timed(check_involution_bwd, device)
    add = timed(check_add2d, device)
    i8 = timed(check_int8, device, qm, model_bf16, x)
    i8_resnet = timed(check_int8, device, rqm, rmodel_bf16, rx, "resnet50")
    i8_rexnet = timed(check_int8, device, xqm, xmodel_bf16, xx, "rexnet1_0x")
    emit({"phase": "rexnet_int8_by_kind", **rexnet_int8_by_kind(i8_rexnet["rows"])})
    grouped = timed(check_int8_grouped, device)
    timed(phase_serving_profile, qm, model_bf16, x, r8)
    timed(phase_serving_profile, rqm, rmodel_bf16, rx, rr8, "resnet_serving_profile")
    timed(phase_serving_profile, xqm, xmodel_bf16, xx, xr8, "rexnet_serving_profile")

    def entry(name, source, replaces, launches, record, max_abs_err):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, **{k: record[k] for k in keys}, "library_ms": record.get("library_ms")}

    inv_src, add_src = "holocron_tpu_torch/csrc/involution.cu", "holocron_tpu_torch/csrc/add2d.cu"
    emit({"kernels": [
        *(entry(name, inv_src, "holocron_tpu/kernels/involution.py:30", inv_launches[name], inv[name],
                inv[name]["max_abs_err"]) for name in ("involution", "involution_general")),
        *(entry(name, inv_src, "holocron_tpu/kernels/involution.py:100", inv_train[name], inv_bwd[name],
                inv_bwd[name]["max_abs_err"]) for name in ("involution_bwd_dxp", "involution_bwd_dkern",
                                                           "involution_bwd_dxp_general",
                                                           "involution_bwd_dkern_general")),
        entry("add2d_fwd", add_src, "holocron_tpu/kernels/add2d.py:20", add2d_launches["add2d_fwd"], add["add2d_fwd"],
              add["add2d_fwd"]["max_abs_err"]),
        *(entry(name, add_src, "holocron_tpu/kernels/add2d.py:82", add2d_launches[name], add[name],
                add[name]["max_abs_err"]) for name in ("add2d_bwd_dp", "add2d_bwd_dw")),
        *int8_entries([serving_launches, resnet_launches, rexnet_launches], [i8, i8_resnet, i8_rexnet], grouped),
    ]})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
