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
   on 2 held-out batches, and bf16 / int8 throughput. A gate miss drops int8 from
   serving and is reported; it does not fail the run.
3. ``involution``: ``Involution2d`` at ``scripts/bench_ops.py:82-87``'s shape (N32,
   56x56, C128, G8, k7, reduction 2, bf16) through the module.
4. ``training``: the repvgg_a0 classification trainer at full width (224 px, batch 128,
   10 classes, random weights from a seed) on synthetic uint8 NCHW batches, as
   ``references/classification/train.py:204-302`` builds it: bf16 compute (``amp``),
   LAMB (lr 1e-3, weight decay 5e-5) under a onecycle schedule, label smoothing 0.1,
   ``gradient_clip=1.0``, ``gradient_acc=2``, ``skip_nan_loss=True``, ImageNet
   ``input_norm``. One epoch of 8 batches and ``evaluate()`` on 2, a timed window of
   steps, one step on a float32 batch holding a NaN (which must be skipped: params,
   moments and the optimizer's count unchanged), and ``check_setup`` for 10 steps on a
   fresh model (the loss must fall).
5. ``involution_train``: ``Involution2d`` at the same shape, forward and backward
   through the module in bf16 (its forward and both gradient kernels).
6. ``add2d``: ``Add2d(64 -> 128, k3, pad 1)`` on N4 x 56 x 56 in float32, forward and
   backward through the module (``scripts/bench_ops.py:112-113``'s layer: L 12544,
   D 576, O 128).
7. ``checks``: each kernel against its plain PyTorch version on the card at the shapes
   the paths gave it, with its time, its plain version's time, the time of one PyTorch
   call computing the same function where there is one (``torch.cdist`` for add2d), and
   its bound: the larger of the bytes it must move over 3.35 TB/s and the operations it
   must do over the card's rate for them. The int8 conv is also timed against cuDNN's
   bf16 conv for one layer.

Each kernel's launch counter is set to 0 just before the path that runs it and read
just after; a kernel that its path never launched fails the run. Then come the
``kernels`` line, the card's name and power limit as ``nvidia-smi`` reports them, and
last ``{"ok": true, "device": {...}}``. Float32 checks run with TF32 off
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
    paths = _build.build(["involution", "int8_conv", "add2d"])
    seconds = time.perf_counter() - t0
    for p in paths:  # the compiler's register / spill report, for the record
        print(p.with_suffix(".log").read_text(), file=sys.stderr)
    emit({"phase": "build", "libraries": [p.name for p in paths], "seconds": round(seconds, 3)})


def phase_serving(device, batch: int = 256, size: int = 224, num_classes: int = 10, iters: int = 30):
    import torch

    from holocron_tpu_torch.kernels import KERNELS
    from holocron_tpu_torch.models import repvgg_a0
    from holocron_tpu_torch.quant import QuantizedConv2d, measure_agreement, quantize_model

    gen = torch.Generator(device=device).manual_seed(SEED)
    model = repvgg_a0(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED), device=device)
    model = model.to(memory_format=torch.channels_last)

    # BN statistics adapted to the input distribution before folding (bench.py:123-124)
    model.train()
    with torch.no_grad():
        for _ in range(4):
            model(naturalistic_batch(gen, batch, size, device))
        model.eval()
        probe = naturalistic_batch(gen, 16, size, device)
        train_eval = model(probe)
        model.reparametrize()
        model = model.to(memory_format=torch.channels_last)
        deploy = model(probe)
    drift = float((train_eval - deploy).abs().max())
    scale = max(1.0, float(train_eval.abs().max()))
    if drift > 1e-3 * scale:  # docs/ARCHITECTURE.md:58
        fail(f"reparametrization drift {drift} > 1e-3 * {scale}")

    model_bf16 = copy.deepcopy(model).to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    x = naturalistic_batch(gen, batch, size, device).to(torch.bfloat16)
    # as bench.py: calibrated on the timing batch in float32, float remainder in bf16
    qm = quantize_model(model, calibration_batches=[x.float()], arch="repvgg_a0").to(torch.bfloat16)
    n_int8 = sum(isinstance(m, QuantizedConv2d) for m in qm.modules())
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
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
        if served:
            for r in requests:
                check_logits(qm(r), r.shape[0], num_classes, "int8 deploy")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    if launches["int8_conv"] == 0:
        fail("the serving path never launched the int8 conv kernel")

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
        "phase": "serving",
        "model": "repvgg_a0",
        "image_size": size,
        "batch": batch,
        "reparam_drift_f32": drift,
        "bf16_vs_f32_max_abs": bf16_vs_f32,
        "bf16_top1_vs_f32": bf16_top1_vs_f32,
        "int8_top1_vs_f32": int8_top1_vs_f32,
        "logit_absmax_f32": float(ref32.abs().max()),
        "int8_convs": n_int8,
        "convs": n_convs,
        "top1_agreement": agreement["top1_agreement"],
        "max_prob_drift": agreement["max_prob_drift"],
        "int8_served": served,
        "served_form": "selective-int8" if served else "bf16",
        "bf16_img_per_s": batch / (bf16_ms / 1e3),
        "int8_img_per_s": batch / (int8_ms / 1e3),
        "bf16_batch8_ms": bf16_b8_ms,
        "int8_batch8_ms": int8_b8_ms,
        "launches": launches,
    })
    return qm, model_bf16, x, launches["int8_conv"]


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
    launches = KERNELS["involution"].launches
    if launches == 0:
        fail("Involution2d never launched the involution kernel")
    if tuple(out.shape) != (n, c, hw, hw) or not bool(torch.isfinite(out).all()):
        fail(f"Involution2d: expected finite output of shape {(n, c, hw, hw)}, got {tuple(out.shape)}")
    with torch.no_grad():
        module_ms = cuda_ms(lambda: module(x), iters)
    torch.cuda.synchronize()
    emit({"phase": "involution", "shape": [n, c, hw, hw], "groups": g, "kernel_size": k, "dtype": "bfloat16",
          "module_ms": module_ms, "launches": launches})
    return launches


def check_involution(device, iters: int = 20) -> dict:
    """Kernel against plain at the module's stencil shapes: bf16 within one bf16 ulp
    of the plain value, f32 within 1e-5 (both accumulate in float32 in one order, so
    both are expected to agree exactly)."""
    import torch

    from holocron_tpu_torch.kernels.involution import involution_stencil, involution_stencil_plain

    n, h, w, c, g, k = 32, 56, 56, 128, 8, 7
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=device)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=device)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        a, b = xp.to(dtype), kern.to(dtype)
        got, ref = involution_stencil(a, b, k, g).float(), involution_stencil_plain(a, b, k, g).float()
        err = (got - ref).abs()
        errs[str(dtype).split(".")[-1]] = float(err.max())
        if dtype == torch.bfloat16 and bool((err > ref.abs() * 2.0**-7).any()):
            fail(f"involution bf16: kernel and plain differ by more than one bf16 ulp (max {float(err.max())})")
        if dtype == torch.float32 and float(err.max()) > 1e-5:
            fail(f"involution f32: max abs error {float(err.max())} > 1e-5")
    a, b = xp.to(torch.bfloat16), kern.to(torch.bfloat16)
    ms = cuda_ms(lambda: involution_stencil(a, b, k, g), iters)
    plain_ms = cuda_ms(lambda: involution_stencil_plain(a, b, k, g), max(1, iters // 4), warmup=1)
    torch.cuda.synchronize()
    # xp and kern read once, out written once, bf16; a multiply and an add per (output, tap)
    nbytes = 2 * (xp.numel() + kern.numel() + n * h * w * c)
    record = {"kernel": "involution", "shape": [n, h, w, c, g, k], "max_abs_err_bf16": errs["bfloat16"],
              "max_abs_err_f32": errs["float32"], "ms": ms, "plain_ms": plain_ms,
              **bound(nbytes, 2 * n * h * w * c * k * k, FP32_INSTR_PER_S)}
    emit({"phase": "check", **record})
    return record


def check_int8(device, qm, model_bf16, x, iters: int = 10) -> dict:
    """The int8 conv against its plain version at every distinct layer geometry of the
    int8 path (inputs captured from the served model on 32 of its images) and at a
    256 -> 256, 14x14 layer: the int32 accumulator exactly; float32 output within one
    float32 ulp and bf16 output within one bf16 ulp of the plain value. Then the
    stage-3 layer at the path's batch of 256: kernel, plain, and cuDNN's bf16 conv."""
    import torch
    from torch.nn import functional as F

    from holocron_tpu_torch.kernels.int8_conv import int8_conv, int8_conv_acc, int8_conv_acc_plain, int8_conv_plain
    from holocron_tpu_torch.quant import QuantizedConv2d, quantize_activation

    captured = {}

    def capture(name):
        def hook(module, args):
            key = (tuple(args[0].shape[1:]), module.kernel_q.shape, module.stride)
            captured.setdefault(key, (name, module, args[0]))

        return hook

    layers = [(name, m) for name, m in qm.named_modules() if isinstance(m, QuantizedConv2d)]
    handles = [m.register_forward_pre_hook(capture(name)) for name, m in layers]
    with torch.no_grad():
        qm(x[:32])
    for hd in handles:
        hd.remove()

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    extra_w = torch.randint(-127, 128, (3, 3, 256, 256), generator=gen, device=device, dtype=torch.int8)
    extra_x = torch.randn(32, 256, 14, 14, generator=gen, device=device).to(torch.bfloat16)
    cases = [(name, m.kernel_q, m.w_scale, m.act_scale, m.bias, m.stride, m.padding, m.dilation, xin)
             for name, m, xin in captured.values()]
    cases.append(("synthetic 256->256 14x14", extra_w, torch.rand(256, generator=gen, device=device) / 127,
                  extra_x.abs().amax().float() / 127, torch.randn(256, generator=gen, device=device),
                  (1, 1), (1, 1), (1, 1), extra_x.contiguous(memory_format=torch.channels_last)))
    max_err = 0.0
    checked = []
    for name, w_q, w_scale, s_x, bias, stride, padding, dilation, xin in cases:
        x_q = quantize_activation(xin, s_x).permute(0, 2, 3, 1).contiguous()
        acc = int8_conv_acc(x_q, w_q, stride, padding, dilation)
        acc_ref = int8_conv_acc_plain(x_q, w_q, stride, padding, dilation)
        if not torch.equal(acc, acc_ref):
            fail(f"int8 conv {name}: int32 accumulator differs from the float64 plain conv")
        for dtype, ulp in ((torch.float32, 2.0**-23), (torch.bfloat16, 2.0**-7)):
            got = int8_conv(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, out_dtype=dtype).float()
            ref = int8_conv_plain(x_q, w_q, s_x, w_scale, bias, stride, padding, dilation, out_dtype=dtype).float()
            err = (got - ref).abs()
            if bool((err > ref.abs() * ulp).any()):
                fail(f"int8 conv {name} {dtype}: output beyond the epilogue's rounding (max {float(err.max())})")
            if dtype == torch.bfloat16:
                max_err = max(max_err, float(err.max()))
        checked.append({"layer": name, "x": list(xin.shape), "w_hwio": list(w_q.shape), "stride": list(stride)})

    # timing: repvgg_a0's stage-3 conv (192 -> 192, 14x14) at batch 256
    name, m, _ = next(v for v in captured.values() if v[1].kernel_q.shape[2:] == (192, 192) and v[1].stride == (1, 1))
    with torch.no_grad():
        xin = None

        def grab(_module, args):
            nonlocal xin
            xin = args[0]

        hd = m.register_forward_pre_hook(grab)
        qm(x)
        hd.remove()
    x_q = quantize_activation(xin, m.act_scale).permute(0, 2, 3, 1).contiguous()
    args = (x_q, m.kernel_q, m.act_scale, m.w_scale, m.bias, m.stride, m.padding, m.dilation)
    ms = cuda_ms(lambda: int8_conv(*args, out_dtype=torch.bfloat16), iters)
    plain_ms = cuda_ms(lambda: int8_conv_plain(*args, out_dtype=torch.bfloat16), iters, warmup=1)
    deploy_conv = dict(model_bf16.named_modules())[name.removeprefix("model.")]
    with torch.no_grad():
        cudnn_ms = cuda_ms(lambda: F.conv2d(xin, deploy_conv.weight, deploy_conv.bias, m.stride, m.padding), iters)
    torch.cuda.synchronize()
    # int8 x read once, int8 weights, bf16 output; 2 operations per multiply-accumulate
    kh, kw, cin, cout = m.kernel_q.shape
    out_shape = int8_conv(*args, out_dtype=torch.bfloat16).shape
    macs = out_shape[0] * out_shape[1] * out_shape[2] * cout * kh * kw * cin
    nbytes = x_q.numel() + m.kernel_q.numel() + 2 * out_shape.numel()
    record = {"kernel": "int8_conv", "checked": checked, "max_abs_err_bf16": max_err, "timed_layer": name,
              "timed_x": list(xin.shape), "ms": ms, "plain_ms": plain_ms, "cudnn_bf16_ms": cudnn_ms,
              **bound(nbytes, 2 * macs, INT8_OPS_PER_S)}
    emit({"phase": "check", **record})
    return record


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


def make_trainer(device, train, val, num_classes: int, **kwargs):
    """The classification reference's trainer (references/classification/train.py:204-302)
    around a fresh repvgg_a0 with weights from the seed."""
    import functools

    import torch

    from holocron_tpu_torch.models import repvgg_a0
    from holocron_tpu_torch.nn.functional import multilabel_cross_entropy
    from holocron_tpu_torch.optim import LAMB
    from holocron_tpu_torch.trainer import ClassificationTrainer

    def criterion(out, target):  # label smoothing 0.1 on one-hot targets (train.py:246-250)
        onehot = torch.nn.functional.one_hot(target, num_classes).to(out.dtype)
        return multilabel_cross_entropy(out, onehot * 0.9 + 0.1 / num_classes)

    model = repvgg_a0(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED), device=device)
    model = model.to(memory_format=torch.channels_last)
    return ClassificationTrainer(
        model, train, val, criterion, functools.partial(LAMB, weight_decay=5e-5), device=device,
        output_file=str(ROOT / "holocron_tpu_torch" / "_build" / "smoke_checkpoint.pt"), amp=True,
        skip_nan_loss=True, gradient_acc=2, gradient_clip=1.0, input_norm=IMAGENET, **kwargs,
    )


def phase_training(device, batch: int = 128, size: int = 224, num_classes: int = 10, timed_steps: int = 6):
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    train = synthetic_batches(gen, 8, batch, size, num_classes, device)
    val = synthetic_batches(gen, 2, batch, size, num_classes, device)
    evaluated = []
    trainer = make_trainer(device, train, val, num_classes, on_epoch_end=evaluated.append)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # one epoch (4 applied updates at gradient_acc=2), then evaluate() on 2 batches; the
    # step is wrapped to keep each batch's loss
    losses = []
    run_step = trainer._run_step_async

    def recorded_step(x, y):
        losses.append(run_step(x, y))
        return losses[-1]

    trainer._run_step_async = recorded_step
    trainer.fit_n_epochs(1, 1e-3)
    trainer._run_step_async = run_step
    losses = [float(v) for v in losses]
    metrics = evaluated[0]
    if len(losses) != 8 or not all(map(math.isfinite, losses)) or not math.isfinite(metrics["val_loss"]):
        fail(f"training: expected 8 finite losses and a finite val_loss, got {losses} and {metrics}")
    if trainer._opt.param_groups[0]["count"] != 4:
        fail(f"training: expected 4 applied updates, got {trainer._opt.param_groups[0]['count']}")

    # a steady window of steps, CUDA events around them
    x, y = train[0]
    for _ in range(2):
        run_step(x, y)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(timed_steps):
        run_step(*train[i % len(train)])
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / timed_steps
    peak_bytes = torch.cuda.max_memory_allocated()

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
    reset_counts()
    module(x).backward(gy)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name].launches for name in names}
    if not all(launches.values()):
        fail(f"Involution2d training never launched some of its kernels: {launches}")
    grads = {"x": x.grad, "reduce.weight": module.reduce.weight.grad, "span.weight": module.span.weight.grad}
    if not all(gr is not None and bool(torch.isfinite(gr).all()) and bool(gr.abs().sum() > 0) for gr in grads.values()):
        fail("Involution2d training: a gradient is missing, zero or not finite")

    def step():
        x.grad = None
        module.zero_grad(set_to_none=True)
        module(x).backward(gy)

    ms = cuda_ms(step, iters)
    torch.cuda.synchronize()
    emit({"phase": "involution_train", "shape": [n, c, hw, hw], "groups": g, "kernel_size": k, "dtype": "bfloat16",
          "fwd_bwd_ms": ms, "launches": launches})
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
    torch.cuda.synchronize()
    emit({"phase": "add2d", "shape": [n, 64, hw, hw], "out_channels": 128, "dtype": "float32", "fwd_bwd_ms": ms,
          "launches": launches})
    return launches


def _excess(got, ref, allowed) -> float:
    """The largest amount by which |got - ref| exceeds its allowed error (<= 0 passes)."""
    return float(((got.float() - ref.float()).abs() - allowed).max())


def check_involution_bwd(device, n: int = 32, hw: int = 56, iters: int = 20) -> dict:
    """Both backward kernels against their plain versions at the module's shapes. dxp:
    the kernel adds in the plain version's tap order with separate roundings, so bf16
    within one bf16 ulp of plain and f32 within 1e-5. dkern: each group's cg = 16
    products are summed in another order (a warp butterfly), so within 1e-5 of the sum
    of their absolute values, plus one bf16 rounding of each side in bf16."""
    import torch

    from holocron_tpu_torch.kernels import involution as V

    h, w, c, g, k = hw, hw, 128, 8, 7
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=device)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=device)
    gout = torch.randn(n, h, w, c, generator=gen, device=device)
    errs = {"dxp": 0.0, "dkern": 0.0}
    for dtype, ulp in ((torch.bfloat16, 2.0**-7), (torch.float32, 0.0)):
        a, b, gg = xp.to(dtype), kern.to(dtype), gout.to(dtype)
        got, ref = V.involution_bwd_dxp(a, b, gg, k, g), V.involution_bwd_dxp_plain(a, b, gg, k, g)
        allowed = ref.float().abs() * ulp if dtype == torch.bfloat16 else torch.full_like(ref.float(), 1e-5)
        if _excess(got, ref, allowed) > 0:
            fail(f"involution dxp {dtype}: kernel and plain differ beyond {'one bf16 ulp' if ulp else '1e-5'}")
        errs["dxp"] = max(errs["dxp"], float((got.float() - ref.float()).abs().max()))
        got, ref = V.involution_bwd_dkern(a, b, gg, k, g), V.involution_bwd_dkern_plain(a, b, gg, k, g)
        absterms = V.involution_bwd_dkern_plain(a.float().abs(), b.float(), gg.float().abs(), k, g)
        if _excess(got, ref, 1e-5 * absterms + ulp * ref.float().abs()) > 0:
            fail(f"involution dkern {dtype}: kernel and plain differ beyond the stated tolerance")
        errs["dkern"] = max(errs["dkern"], float((got.float() - ref.float()).abs().max()))
        del got, ref, absterms
    a, b, gg = xp.to(torch.bfloat16), kern.to(torch.bfloat16), gout.to(torch.bfloat16)
    records = {}
    ops = 2 * n * h * w * c * k * k  # a multiply and an add per (output element, tap)
    for name, fn, plain, nbytes in (
        ("involution_bwd_dxp", V.involution_bwd_dxp, V.involution_bwd_dxp_plain, 2 * (b.numel() + gg.numel() + a.numel())),
        ("involution_bwd_dkern", V.involution_bwd_dkern, V.involution_bwd_dkern_plain,
         2 * (a.numel() + gg.numel() + b.numel())),
    ):
        ms = cuda_ms(lambda: fn(a, b, gg, k, g), iters)
        plain_ms = cuda_ms(lambda: plain(a, b, gg, k, g), max(1, iters // 4), warmup=1)
        key = name.rsplit("_", 1)[1]
        records[name] = {"max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms, "library_ms": None,
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
    if not torch.equal(A.add2d_bwd_dw(p, w, gg), A.add2d_bwd_dw(p, w, gg)):
        fail("add2d_bwd_dw: two runs on the same inputs differ")
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

    phase_build()
    qm, model_bf16, x, int8_launches = phase_serving(device)
    inv_launches = phase_involution(device)
    phase_training(device)
    inv_train = phase_involution_train(device)
    add2d_launches = phase_add2d(device)
    inv = check_involution(device)
    inv_bwd = check_involution_bwd(device)
    add = check_add2d(device)
    i8 = check_int8(device, qm, model_bf16, x)

    def entry(name, source, replaces, launches, record, max_abs_err):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, **{k: record[k] for k in keys}, "library_ms": record.get("library_ms")}

    inv_src, add_src = "holocron_tpu_torch/csrc/involution.cu", "holocron_tpu_torch/csrc/add2d.cu"
    emit({"kernels": [
        entry("involution", inv_src, "holocron_tpu/kernels/involution.py:30", inv_launches, inv,
              max(inv["max_abs_err_bf16"], inv["max_abs_err_f32"])),
        *(entry(name, inv_src, "holocron_tpu/kernels/involution.py:100", inv_train[name], inv_bwd[name],
                inv_bwd[name]["max_abs_err"]) for name in ("involution_bwd_dxp", "involution_bwd_dkern")),
        entry("add2d_fwd", add_src, "holocron_tpu/kernels/add2d.py:20", add2d_launches["add2d_fwd"], add["add2d_fwd"],
              add["add2d_fwd"]["max_abs_err"]),
        *(entry(name, add_src, "holocron_tpu/kernels/add2d.py:82", add2d_launches[name], add[name],
                add[name]["max_abs_err"]) for name in ("add2d_bwd_dp", "add2d_bwd_dw")),
        entry("int8_conv", "holocron_tpu_torch/csrc/int8_conv.cu", "holocron_tpu/quant.py:259", int8_launches, i8,
              i8["max_abs_err_bf16"]),
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
