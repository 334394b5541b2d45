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
4. ``checks``: each kernel against its plain PyTorch version on the card at the shapes
   the paths gave it, and the int8 conv against cuDNN's bf16 conv for one layer.

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
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
AGREEMENT_FLOOR = 0.99  # bench.py:150-157


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
    paths = _build.build(["involution", "int8_conv"])
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
    record = {"kernel": "involution", "shape": [n, h, w, c, g, k], "max_abs_err_bf16": errs["bfloat16"],
              "max_abs_err_f32": errs["float32"], "ms": ms, "plain_ms": plain_ms}
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
    record = {"kernel": "int8_conv", "checked": checked, "max_abs_err_bf16": max_err, "timed_layer": name,
              "timed_x": list(xin.shape), "ms": ms, "plain_ms": plain_ms, "cudnn_bf16_ms": cudnn_ms}
    emit({"phase": "check", **record})
    return record


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
    inv = check_involution(device)
    i8 = check_int8(device, qm, model_bf16, x)

    emit({"kernels": [
        {"name": "involution", "route": "cuda", "source": "holocron_tpu_torch/csrc/involution.cu",
         "replaces": "holocron_tpu/kernels/involution.py:30", "launches": inv_launches,
         "max_abs_err": max(inv["max_abs_err_bf16"], inv["max_abs_err_f32"]), "ms": inv["ms"],
         "plain_ms": inv["plain_ms"]},
        {"name": "int8_conv", "route": "cuda", "source": "holocron_tpu_torch/csrc/int8_conv.cu",
         "replaces": "holocron_tpu/quant.py:259", "launches": int8_launches,
         "max_abs_err": i8["max_abs_err_bf16"], "ms": i8["ms"], "plain_ms": i8["plain_ms"]},
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
