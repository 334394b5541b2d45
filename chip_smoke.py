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
12. ``bench``: ``python -m holocron_tpu_torch.bench``'s protocol (``bench.py:72-175``
   of the JAX package: BN adapted, ``reparametrize()``, bf16 and the gated
   selective-int8 form timed through the captured deploy forward at batch 256) on
   repvgg_a0 twice and rexnet1_0x once, each run's JSON line printed; the two
   repvgg_a0 gates must read the same.
13. ``deploy_graph``: ``models.core.deploy_forward`` (one CUDA graph a batch bucket,
   1/2/4/8) in four forms, repvgg_a0 bf16 and int8 (logits) and the service's
   rexnet1_0x float32 and int8 with float32 output (uint8 in, softmax inside): each
   bucket's replay equal to the eager forward bit for bit; each capture holding the
   quantization and the conv once an int8 layer; batch-8 latency, graph against eager
   (CUDA events and wall time). (After the checks, a ``deploy_graph_profile`` line:
   kernel time, idle share and the int8 kernels a replay, from ``torch.profiler``.)
14. ``service``: ``holocron_tpu_torch.api``'s stdlib server on 127.0.0.1 with
   rexnet1_0x on the card, float32 and under ``HOLOCRON_QUANTIZE=force``: ``GET
   /status``, the repository's JPEG asset posted, a non-image body (400), and
   ``bench_serving``'s closed loop at concurrency 1, 4, 16 and 64 (p50/p90/p99, req/s,
   mean device batch); every request a graph replay.
15. ``darknet_zoo`` (after ``resnet_zoo``): the same forwards of darknet24, darknet19,
   darknet53, cspdarknet53 and cspdarknet53_mish (224 px, batch 32), each parameter
   count held against the JAX package's at 10 classes. ``darknet_serving`` (after
   ``rexnet_serving``): the serving path for darknet53, BN kept: 49 ``wgmma`` convs.
16. ``detection_serving`` (after ``service``): yolov4 at 608 px, 80 classes, bf16 and
   selective int8 (102 ``wgmma`` convs, the three prediction convs 255 wide) at batch
   8 and 32, eager and through ``deploy_forward``'s graphs: the raw forward,
   ``post_process`` alone and both together (ms, img/s, idle share; the replays' boxes,
   scores, labels and keep masks equal to eager, bit for bit), the NMS pass alone; the
   box-F1 int8 gate (``scripts/quant_accuracy.py``'s threshold ladder, then
   ``measure_agreement_detection``) on 2 batches of 8, which fails on no detection;
   each int8 conv's batch-8 input against the plain versions; yolov1 at 448 px and
   yolov2 at 416 px in bf16. ``detection_training``: the detection reference's trainer
   (amp, TAdam, onecycle, ``max_boxes`` 50) on yolov2 at 416 px (an epoch of 4 batches of
   8 through ``fit_n_epochs``, ``evaluate()``, the four losses, finite gradients with
   padded target slots, ms a step, peak memory, kernels a step) and yolov4 at 608 px
   (2 timed steps).
17. ``segmentation_zoo`` (after ``detection_training``): an f32 and a bf16 forward of each
   of the eight segmentation factories (unet, unetp, unetpp, unet3p, unet2,
   unet_tvvgg11, unet_tvresnet34, unet_rexnet13) at full width, 256 px, 21 classes,
   batch 32: logits ``(32, 21, 256, 256)``, finite, bf16 ms. ``segmentation_serving``:
   unet3p (the segmentation CLI's default) at 256 px, BN adapted on 4 naturalistic
   batches, bf16 and selective int8 (33 ``wgmma`` convs: 320- and 1024-wide inputs,
   biased convs without BN, a 21-wide head) at batch 8 and 32, eager and through
   ``deploy_forward``'s graphs (every replay bit-equal to eager), the pixel-agreement
   gate (pixel agreement and mean mask IoU against bf16) on 2 held-out batches of 32,
   the batch-32 forwards profiled. ``segmentation_training``: the segmentation CLI's
   ``main()`` in-process (unet3p, batch 16, 256 px, amp, AdamP, onecycle, an epoch of 4
   batches and ``evaluate()``), then ms a step and peak memory in bf16 and in float32,
   kernels a step and the idle share.
18. ``mobileone_serving`` and ``convnext_serving`` (after ``segmentation_training``):
   the serving path for mobileone_s1 (BN adapted, reparametrized: 21 ``wgmma`` 1x1
   convs; its depthwise convs stay bf16) and for convnext_tiny (every LayerScale drawn
   from a seeded normal of std 0.1 first, said in the line: at its 1e-6 init the gate
   would see the stem, the downsamples and the head alone; 39 ``wgmma`` convs, 36 1x1
   and the three 2x2 stride-2 downsamples), each followed by a ``*_serving_graphs``
   line: bf16 and int8 at batch 8 and 256 through ``deploy_forward``'s graphs, every
   replay equal to eager bit for bit (last, ``mobileone_serving_profile`` and
   ``convnext_serving_profile`` lines: the forwards' kernels, ConvNeXt's by kind).
   ``classification_zoo_more``: an f32 and a bf16
   forward of mobileone_s0-s3 (train form and reparametrized, the drift) and
   convnext_atto-xl at batch 32. ``classification_cli``: the classification CLI's
   ``main()`` on an Imagenette-shaped folder it writes (convnext_tiny, Adan, amp, the
   default recipe, one epoch, then ``--test-only --resume``) and on ``fake``
   (mobileone_s1, LARS): the decode route, ms a step, the loader's wait, peak memory.
   ``optim_zoo``: 4 steps of mobileone_s1 (batch 64, amp) under LARS, RaLars, Adan,
   AdEMAMix, Lookahead and Scout (around AdamP), no optimizer step reading the device.
19. The tools' phases (after ``optim_zoo``): ``detection_cli``, the detection CLI's
   ``main()`` at the JAX CLI's defaults (yolov2, darknet19, 20 classes, 416 px, batch 8,
   TAdam, onecycle) with ``--amp`` and 8 spawned loader workers, on ``fake`` (32 samples,
   4 steps) and on a folder of JPEGs and PNGs it writes (16 + 8 images), then
   ``--test-only --resume`` and ``--check-setup``; ``pretrained``, checkpoints written
   with ``torch.save`` loaded through ``file://`` (rexnet1_0x's logits, darknet19 into
   yolov2's backbone, a sha256 mismatch); ``remat``, resnet50 at batch 128 under
   ``remat`` False, True and ``"dots"`` (ms a step, peak memory; the same losses at
   each step, BN statistics and first update of each parameter); ``binary_trainer``, ``BinaryClassificationTrainer`` on rexnet1_0x
   with one output and the top-loss collection; ``export``, repvgg_a0 in bf16 and int8
   (its graph holding the ``holocron_tpu_torch`` int8 ops, which launch the kernels)
   and yolov2 with its post-processing, exported, saved, loaded and run against eager;
   ``latency_and_zoo``, ``eval_latency`` on rexnet1_0x (batch 8 and 256, bf16 and int8)
   and ``bench_zoo`` over one architecture a family. ``profiling`` runs last, after the
   other profiles: ``utils.profiling.device_op_summary`` against ``profile_forward`` on
   rexnet1_0x's bf16 forward at batch 256, within 5%, and within 0.85-1.03 of its
   device time from CUDA events. Every profile is read from the profiler's chrome trace,
   over a ``record_function`` window between padding calls (late in a long run a
   session lost about 6 ms of kernel records at its edges).
20. ``checks``: each kernel against its plain PyTorch version on the card at the shapes
   the paths gave it, with its time, its plain version's time, the time of one PyTorch
   call computing the same function where there is one (``torch.cdist`` for add2d), and
   its bound: the larger of the bytes it must move over 3.35 TB/s and the operations it
   must do over the card's rate for them. Both routes of the involution forward and
   backward (tiled and general) are checked and timed at the path's shape. The int8
   routes are checked (bit-exact quantization, also on inputs on its ties and beyond
   its clip; exact accumulator; outputs within one ulp) at each int8 layer geometry of
   repvgg_a0 (nine), resnet50 (22), rexnet1_0x (44), darknet53 (13), unet3p (30, at
   its path's batch of 32), mobileone_s1 (7) and convnext_tiny (11) at batch 8 and 32
   (an ``int8_sums_by_kernel`` line after each of the last two: the 1x1 and 2x2
   stride-2 layers' sums against cuDNN bf16 and ``torch._int_mm``), checked again
   and timed at each at batch 256 (``check_int8_geometry`` lines, device time from CUDA
   graphs): quantize + conv, each kernel, cuDNN's bf16 conv of the layer, the plain
   version, ``torch._int_mm`` on the same int8 operands for each 1x1 stride-1
   geometry (the library call, alone, no epilogue), and the bounds of the route and of
   each kernel. Then a ``rexnet_int8_by_kind`` line sums rexnet1_0x's geometries by
   kind of conv. The grouped general route the same way at resnext101_32x8d's stage-4
   3x3 conv (32 groups of 64, stride 1 and 2; its 16-byte staging), and checked at two
   odd per-group widths (its byte-wise staging): the only launches of
   ``int8_conv_general``, which no serving path runs (its check fails if it launched no
   time). Last, ``int8_op_dispatch``: the host's time a quantized conv through the
   ``holocron_tpu_torch`` int8 ops against the same launches made directly, in 10
   interleaved pairs of loops.

Each kernel's launch counter is set to 0 just before the path that runs it and read
just after; a kernel that its path never launched fails the run (a graph replay makes
no call that a counter sees: the profiler counts the kernels of the replays). Then come
the ``kernels`` line (the int8 entries over the serving, bench, deploy-graph, service,
detection-serving, segmentation-serving, export and latency paths; their times summed over the
repvgg_a0, resnet50 and rexnet1_0x geometries), the card's name and power
limit as ``nvidia-smi`` reports them, and last ``{"ok": true, "device": {...}}``. Each
phase's wall time goes to stderr. Float32 checks run with TF32 off
(``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``).
Any mismatch or error exits non-zero; so does a machine with no CUDA device, or a
directory that holds this script without the package.
"""

import copy
import io
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
                  phase: str = "serving", batch: int = 256, size: int = 224, num_classes: int = 10, iters: int = 30,
                  prepare=None):
    """The serving path of ``arch``; a model with ``reparametrize`` (RepVGG, MobileOne)
    is folded into its deploy form, one without (ResNet, ReXNet, ConvNeXt) is served
    with BN after each conv, as the JAX package serves it. ``prepare(model, generator)``,
    where given, sets weights the seed's initialization leaves degenerate, before
    anything else; its docstring goes into the line as ``prepared``. Fails unless
    ``int8_layers`` convs are int8, ``wgmma_layers`` of them on the ``wgmma`` route and
    the rest on the general route, and unless each int8 conv launched the route
    ``conv_route`` picks for it once a forward. The int8 requests run whether or not
    the gate passes."""
    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.kernels import KERNELS
    from holocron_tpu_torch.kernels.int8_conv import conv_route
    from holocron_tpu_torch.quant import QuantizedConv2d, measure_agreement, quantize_model

    gen = torch.Generator(device=device).manual_seed(SEED)
    model = getattr(models, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                  device=device)
    model = model.to(memory_format=torch.channels_last)
    if prepare is not None:
        prepare(model, gen)

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
        **({"prepared": " ".join(prepare.__doc__.split())} if prepare is not None else {}),
        **reparam,
        "bf16_vs_f32_max_abs": bf16_vs_f32,
        "bf16_top1_vs_f32": bf16_top1_vs_f32,
        "int8_top1_vs_f32": int8_top1_vs_f32,
        "logit_absmax_f32": float(ref32.abs().max()),
        "int8_convs": n_int8,
        "int8_convs_wgmma": n_wgmma,
        "int8_convs_general": n_int8 - n_wgmma,
        "int8_geometries": int8_geometries(qm),
        "convs": n_convs,
        "top1_agreement": agreement["top1_agreement"],
        "max_prob_drift": agreement["max_prob_drift"],
        "int8_served": served,
        "served_form": "selective-int8" if served else "bf16",
        # bench.py:162's choice: the faster of bf16 and the int8 form that passed the gate
        "best_form": "selective-int8" if served and int8_ms < bf16_ms else "bf16",
        "bf16_img_per_s": batch / (bf16_ms / 1e3),
        "int8_img_per_s": batch / (int8_ms / 1e3),
        "int8_over_bf16": bf16_ms / int8_ms,
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


def profile_forward(fn, x, steps: int = 5, top: int = 10, count: tuple = (), pad: int = 3,
                    attempts: int = 3) -> dict:
    """``torch.profiler`` over ``steps`` forwards after warm-up, read from its chrome
    trace (``utils.profiling.trace_kernels``: a CUDA graph's replayed kernels included):
    host wall ms (inflated by the profiler itself), summed kernel ms, idle share (1 -
    kernel / wall) and launches per forward, and the kernels that take the most device
    time; ``counts``: for each name in ``count``, the launches a forward of the kernels
    whose name holds it. The counted forwards run inside a ``record_function`` range
    between ``pad`` forwards on each side, and only the kernels of the launches made in
    it count: late in a long run the profiler loses about 175 kernel records at a
    session's edges (on an H100: 7% of rexnet1_0x's kernel time over 5 forwards). A
    profile that lost a kernel of the range is taken again, at most ``attempts`` times
    (``profiles``); then it raises ``ValueError``. ``pad_kernels_missing``: the kernels
    that the padding forwards ran, as many a forward as the window's, less those the
    trace holds: what the session lost at its edges."""
    import tempfile
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from holocron_tpu_torch.utils.profiling import WINDOW, trace_kernels

    for attempt in range(1, attempts + 1):
        with torch.no_grad():
            for _ in range(3):
                fn(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(pad):
                    fn(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with record_function(WINDOW):
                    for _ in range(steps):
                        fn(x)
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
                for _ in range(pad):
                    fn(x)
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="holocron_profile_") as tmp:
            prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
            try:
                kernels = trace_kernels(Path(tmp) / "trace.json", window=WINDOW)
                outside = len(trace_kernels(Path(tmp) / "trace.json")) - len(kernels)
                break
            except ValueError:
                if attempt == attempts:
                    raise
    totals, launches = defaultdict(float), defaultdict(int)
    for name, us in kernels:
        totals[name] += us
        launches[name] += 1
    ranked = sorted(totals, key=lambda k: -totals[k])
    kernel_ms = sum(totals.values()) / 1e3 / steps
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "idle": 1 - kernel_ms / wall_ms,
            "kernel_launches": len(kernels) / steps, "profiles": attempt,
            "pad_kernels_missing": 2 * pad * len(kernels) / steps - outside,
            "counts": {name: sum(n for k, n in launches.items() if name in k) / steps for name in count},
            "top": [[k[:90], totals[k] / 1e3 / steps, launches[k] / steps] for k in ranked[:top]]}


INT8_KERNEL_NAMES = ("int8_conv_wgmma_kernel", "int8_quantize")  # the kernels' names in a profile
PROFILED_STEPS = 5  # the forwards phase_deploy_graph_profile profiles a form


def int8_launches() -> dict:
    """The int8 kernels' launch counters (calls from Python: a graph replay makes none)."""
    from holocron_tpu_torch.kernels import KERNELS

    return {"int8_conv": KERNELS["int8_conv"].launches, "int8_quantize": KERNELS["int8_quantize"].launches,
            "int8_conv_general": KERNELS["int8_conv_general"].launches}


def phase_bench(device) -> dict:
    """``python -m holocron_tpu_torch.bench``'s protocol (``bench.run``, batch 256, 224
    px) on repvgg_a0 twice and on rexnet1_0x once; prints each run's JSON line. Fails
    if the int8 form failed in a run, or if the two repvgg_a0 gates read differently
    (their weights and gate come from one seed with deterministic cuDNN)."""
    from holocron_tpu_torch import bench

    reset_counts()
    runs = []
    for arch in ("repvgg_a0", "repvgg_a0", "rexnet1_0x"):
        r = bench.run(arch, device=device)
        if r["int8_error"] is not None:
            fail(f"bench {arch}: the int8 form failed:\n{r['int8_error']}")
        line = {k: r[k] for k in ("metric", "value", "unit", "vs_baseline")}
        print(json.dumps(line), flush=True)
        runs.append({"arch": arch, **line, "bf16_img_per_s": r["bf16_img_per_s"],
                     "int8_img_per_s": r["int8_img_per_s"], **r["agreement"]})
    if runs[0]["top1_agreement"] != runs[1]["top1_agreement"] or runs[0]["max_prob_drift"] != runs[1]["max_prob_drift"]:
        fail(f"bench: the two repvgg_a0 gates differ: {runs[0]} against {runs[1]}")
    launches = int8_launches()
    if not launches["int8_conv"] or not launches["int8_quantize"]:
        fail(f"bench: the int8 forms launched no int8 kernel ({launches})")
    emit({"phase": "bench", "runs": runs, "launches": launches})
    return launches


def _service_form(device, arch: str, quantize):
    """The model the service builds for ``arch`` on the card (float32, reparametrized
    where it can be, int8 with per-call scales when ``quantize`` is "force")."""
    from holocron_tpu_torch.api import config, vision

    config.ARCH, config.DEVICE, config.QUANTIZE = arch, str(device), quantize
    return vision.load_model()


def phase_deploy_graph(device, qm, model_bf16, buckets=(1, 2, 4, 8), size: int = 224, iters: int = 50) -> tuple:
    """``models.core.deploy_forward`` against the eager forward in four forms: repvgg_a0
    in bf16 and int8 (the serving phase's models; normalized NCHW in, logits out) and
    rexnet1_0x in float32 and int8 with float32 output (the service's models, per-call
    activation scales; uint8 NHWC in, probabilities out). Building it must launch each
    int8 kernel once an int8 layer in each warm-up forward and each bucket's capture: a
    graph holds, and each replay runs, the quantization and the conv once an int8
    layer. At each bucket, and at a batch of 3 padded to 4, the replay's output must
    equal the eager forward's on the same (padded) input bit for bit. At batch 8: the
    device time a call from CUDA events and the wall time a call (host clock,
    synchronized), for the graph and the eager forward. Returns each form's record,
    forwards, model and batch-8 input for :func:`phase_deploy_graph_profile` and
    :func:`check_int8_service`, which run once the timed phases are done, and the int8
    kernels' launches the counters saw (warm-ups, captures and eager forwards)."""
    import functools

    import torch

    from holocron_tpu_torch.models.core import WARMUP, deploy_forward, softmax_forward
    from holocron_tpu_torch.models.presets import IMAGENETTE
    from holocron_tpu_torch.quant import QuantizedConv2d

    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    mean_std = (IMAGENETTE.mean, IMAGENETTE.std)
    mean, std = (torch.tensor(v, device=device).reshape(1, 3, 1, 1) for v in mean_std)
    forms = (("repvgg_a0", "bf16", lambda: model_bf16, False), ("repvgg_a0", "int8", lambda: qm, False),
             ("rexnet1_0x", "float32", lambda: _service_form(device, "rexnet1_0x", False), True),
             ("rexnet1_0x", "int8_f32", lambda: _service_form(device, "rexnet1_0x", "force"), True))
    reset_counts()
    out = []
    for arch, form, build, u8 in forms:
        model = build()
        n_int8 = sum(isinstance(m, QuantizedConv2d) for m in model.modules())
        eager = functools.partial(softmax_forward, model, mean=mean, std=std) if u8 else model
        before = int8_launches()
        graph = deploy_forward(model, buckets, size, mean_std if u8 else None)
        captured = {k: v - before[k] for k, v in int8_launches().items()}
        expected = (WARMUP + 1) * len(buckets) * n_int8
        if captured != {"int8_conv": expected, "int8_quantize": expected, "int8_conv_general": 0}:
            fail(f"deploy_graph {arch} {form}: building the graphs launched {captured}, expected {expected} "
                 "of each int8 kernel")
        replay = graph

        def batch_of(n):
            if u8:
                return torch.randint(0, 256, (n, size, size, 3), generator=gen, device=device, dtype=torch.uint8)
            return torch.randn(n, 3, size, size, generator=gen, device=device).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)

        record = {"model": arch, "form": form, "batch": 8, "buckets": list(buckets), "int8_convs": n_int8,
                  "capture_int8_launches": captured}
        with torch.no_grad():
            for n in (*buckets, 3):
                xb = batch_of(n)
                got = replay(xb).clone()
                pad = next(b for b in buckets if b >= n) - n  # the graph pads with the last sample
                want = eager(torch.cat([xb, xb[-1:].expand(pad, *xb.shape[1:])]))[:n]
                if not torch.equal(got, want):
                    fail(f"deploy_graph {arch} {form}: the replay at batch {n} differs from the eager forward "
                         f"(max {float((got.float() - want.float()).abs().max())})")
            x8 = batch_of(8)
            for name, fn in (("graph", replay), ("eager", eager)):
                device_ms = cuda_ms(lambda: fn(x8), iters)
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x8)
                    torch.cuda.synchronize()
                record[name] = {"device_ms": device_ms, "wall_ms": (time.perf_counter() - t0) * 1e3 / iters}
        record["eager_over_graph_wall"] = record["eager"]["wall_ms"] / record["graph"]["wall_ms"]
        emit({"phase": "deploy_graph", **record})
        out.append({"record": record, "fns": {"graph": replay, "eager": eager}, "model": model, "u8": u8, "x8": x8})
    torch.cuda.synchronize()
    return out, int8_launches()


def phase_deploy_graph_profile(forms: list) -> dict:
    """``torch.profiler`` over the batch-8 graph replays and eager forwards of
    :func:`phase_deploy_graph`'s forms (after the timed phases: once the profiler has
    run, the host launches more slowly; ``profile_forward`` counts a window between
    padding forwards and takes a profile that lost a kernel in it again): kernel ms and
    launches a forward, the idle share 1 - kernel ms / the unprofiled wall ms, and the
    int8 kernels the profiler saw a forward, which must be some and at most one
    quantization and one conv an int8 layer in a replay as in the eager forward (the
    exact count a replay runs is held where the graphs are built). Returns the
    int8 launches the counters saw (the eager forwards, padding included) and, apart,
    the int8 kernels the profiler saw in the counted replays."""
    reset_counts()
    seen = {"int8_conv": 0, "int8_quantize": 0, "int8_conv_general": 0}
    for form in forms:
        record, n_int8 = form["record"], form["record"]["int8_convs"]
        line = {"phase": "deploy_graph_profile", "model": record["model"], "form": record["form"], "batch": 8}
        for name, fn in form["fns"].items():
            prof = profile_forward(fn, form["x8"], steps=PROFILED_STEPS, count=INT8_KERNEL_NAMES)
            per = prof["counts"].values()
            if any(not (0 < v <= n_int8) for v in per) if n_int8 else any(per):
                fail(f"deploy_graph {record['model']} {record['form']} {name}: the profiler saw int8 kernels "
                     f"{prof['counts']} a forward, expected some and at most {n_int8} of each")
            line[name] = {"kernel_ms": prof["kernel_ms"], "kernel_launches": prof["kernel_launches"],
                          "idle": 1 - prof["kernel_ms"] / record[name]["wall_ms"], "int8_per_forward": prof["counts"],
                          "profiled_wall_ms": prof["wall_ms"], "profiles": prof["profiles"], "top": prof["top"][:5]}
            if name == "graph":
                for key, kernel in zip(("int8_conv", "int8_quantize"), INT8_KERNEL_NAMES):
                    seen[key] += round(prof["counts"][kernel] * PROFILED_STEPS)
        emit(line)
    return int8_launches(), seen


def _request(port: int, method: str, path: str, body: bytes = None) -> tuple:
    """One request to the service on its own connection: status, JSON body, headers."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def phase_service(device, requests: int = 100, concurrency=(1, 4, 16, 64)) -> dict:
    """The classification service (``holocron_tpu_torch.api``) on the card, in a thread
    on 127.0.0.1, rexnet1_0x (the API's default), in its float32 form and under
    ``HOLOCRON_QUANTIZE=force``. For each form: the model loaded and every bucket
    captured (``vision.get_batcher``), ``GET /status``, the JPEG asset posted (200, a
    label of the model's classes, the ``X-*`` stage headers), a non-image body (400),
    ``requests / 2`` sequential requests (the stage attribution: decode, queue, device
    call, the rest of the host's time), then ``bench_serving``'s closed loop at each
    concurrency with about ``requests`` timed requests (at least ``MIN_PER_CLIENT`` a
    client), every one of which must be answered 200. The int8 kernels must have been launched by the captures alone (the
    quantization and the conv once an int8 layer in each of the warm-up forwards and the
    capture of each of the 4 buckets) and by no request: every request replays a graph,
    which runs the kernels its capture recorded. Names the JPEG decoder that served."""
    import importlib.util
    import threading

    from holocron_tpu_torch import bench_serving
    from holocron_tpu_torch.api import main as api_main
    from holocron_tpu_torch.api import config, vision
    from holocron_tpu_torch.models.core import WARMUP
    from holocron_tpu_torch.quant import QuantizedConv2d
    from holocron_tpu_torch.utils.data import native_available

    decoder = "native" if native_available() else "PIL" if importlib.util.find_spec("PIL") else None
    if decoder is None:
        fail("service: no JPEG decoder (neither g++ with libjpeg nor PIL) on this machine")
    payload = bench_serving.ASSET.read_bytes()
    config.ARCH, config.DEVICE = "rexnet1_0x", str(device)
    srv = api_main.serve("127.0.0.1", 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    total = {"int8_conv": 0, "int8_quantize": 0, "int8_conv_general": 0}
    try:
        for form, quantize in (("float32", False), ("int8", "force")):
            vision.reset()
            config.QUANTIZE = quantize
            reset_counts()
            t0 = time.perf_counter()
            vision.get_batcher()
            setup_s = time.perf_counter() - t0
            n_int8 = sum(isinstance(m, QuantizedConv2d) for m in vision.get_model().modules())
            if n_int8 != (44 if quantize else 0):
                fail(f"service {form}: {n_int8} int8 convs")
            captured = int8_launches()
            expected = (WARMUP + 1) * 4 * n_int8  # the warm-ups and the capture of each of the 4 buckets
            if captured != {"int8_conv": expected, "int8_quantize": expected, "int8_conv_general": 0}:
                fail(f"service {form}: the captures launched {captured}, expected {expected} of each int8 kernel")
            s_code, s_body, _ = _request(port, "GET", "/status")
            if s_code != 200 or s_body.get("status") != "ok":
                fail(f"service {form}: GET /status answered {s_code} {s_body}")
            c_code, c_body, c_headers = _request(port, "POST", "/classification", payload)
            if (c_code != 200 or c_body.get("value") not in vision.CLASSES or not 0 <= c_body.get("confidence", -1) <= 1
                    or any(h not in c_headers for h in ("X-Decode-Ms", "X-Queue-Ms", "X-Infer-Ms", "X-Batch-Size"))):
                fail(f"service {form}: POST of the JPEG answered {c_code} {c_body} {c_headers}")
            b_code, _, _ = _request(port, "POST", "/classification", b"not an image")
            if b_code != 400:
                fail(f"service {form}: a non-image body answered {b_code}, expected 400")
            sequential = bench_serving.sequential(port, payload, requests // 2)
            rows = []
            for k in concurrency:
                row = bench_serving.closed_loop(port, payload, k, bench_serving.per_client(requests, k))
                if row["n"] != k * bench_serving.per_client(requests, k):
                    fail(f"service {form}: {row['n']} answers at concurrency {k}")
                rows.append(row)
            launches = int8_launches()
            if launches != captured:
                fail(f"service {form}: requests launched int8 kernels from Python ({launches} against the "
                     f"captures' {captured}): they ran eagerly, not as graph replays")
            for key, v in launches.items():
                total[key] += v
            emit({"phase": "service", "model": "rexnet1_0x", "form": form, "decoder": decoder, "cudnn_tf32": False,
                  "setup_s": setup_s, "int8_convs": n_int8, "answer": c_body, "sequential": sequential,
                  "closed_loop": rows,
                  "launches": launches})
    finally:
        srv.shutdown()
        srv.server_close()
        vision.reset()
    return total


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


def captured(fn, iters: int = 1, warmup: int = 1):
    """``iters`` calls of ``fn`` captured in one CUDA graph, after ``warmup`` calls on a
    side stream (first-launch set-up outside the capture); returns the graph's replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph.replay


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Mean device time of ``fn`` in ms: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so that host time spent in the
    wrappers between launches does not count."""
    import torch

    replay = captured(fn, iters, warmup=3)
    replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        replay()
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
        for b in sorted({8, 32, x.shape[0]}):
            qm(x[:b])
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


def check_int8_service(device, forms: list, batches=(8, 1)) -> dict:
    """The int8 kernels at the shapes the service's int8 form gives them (float32
    activations, per-call scales, rexnet1_0x's widths): each ``QuantizedConv2d`` input
    of :func:`phase_deploy_graph`'s uint8-in int8 form, hooked in its eager forward at
    each of ``batches``, held against the plain versions (``_int8_case_holds``) with the
    scale that layer computed for that call."""
    import torch

    from holocron_tpu_torch.kernels import int8_conv as K
    from holocron_tpu_torch.quant import QuantizedConv2d

    form = next(f for f in forms if f["u8"] and f["record"]["int8_convs"])
    model, eager, size = form["model"], form["fns"]["eager"], form["x8"].shape[1]
    layers = [(name, m) for name, m in model.named_modules() if isinstance(m, QuantizedConv2d)]
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    cases = []

    def capture(name, module):
        def hook(_, args):
            cases.append((name, module, args[0], module.activation_scale(args[0])))

        return hook

    handles = [m.register_forward_pre_hook(capture(name, m)) for name, m in layers]
    try:
        with torch.no_grad():
            for b in batches:
                eager(torch.randint(0, 256, (b, size, size, 3), generator=gen, device=device, dtype=torch.uint8))
    finally:
        for hd in handles:
            hd.remove()
    if len(cases) != len(layers) * len(batches) or any(x.dtype != torch.float32 for _, _, x, _ in cases):
        fail(f"int8 service check: hooked {len(cases)} float32 inputs, expected {len(layers) * len(batches)}")
    max_err = {"wgmma": 0.0, "general": 0.0}
    for name, m, xin, s_x in cases:
        route = K.conv_route(m.kernel_q.shape[2], m.kernel_q.shape[3], m.groups)
        _int8_case_holds(f"{form['record']['model']} {form['record']['form']} {name} batch {xin.shape[0]}", route,
                         xin.permute(0, 2, 3, 1), s_x, m.kernel_q, m.kernel_packed, m.w_scale, m.bias, m.stride,
                         m.padding, m.dilation, m.groups, max_err)
    torch.cuda.synchronize()
    record = {"kernel": "int8_conv", "model": form["record"]["model"], "form": form["record"]["form"],
              "input_dtype": "float32", "batches": list(batches), "cases": len(cases),
              "channels": sorted({int(x.shape[1]) for _, _, x, _ in cases}), "max_abs_err_bf16": max_err}
    emit({"phase": "check_int8_service", **record})
    return record


def check_int8_dispatch(device, pairs: int = 10, calls: int = 2000) -> dict:
    """The host's cost a call of the ``holocron_tpu_torch`` int8 ops: a quantized conv
    through the ops (``quantized_conv``: ``int8_quantize`` then ``int8_conv``) against
    the same two launches made directly (``_quantize_launch`` and ``_launch``, the calls
    that ``quantize_activation`` and ``int8_conv`` made before the ops), in ``pairs``
    interleaved pairs of loops of ``calls`` convs each (the ops first in even pairs), on
    a 1x1 conv of 64 channels over one 8 x 8 image in bf16: its two kernels take less
    device time than a call takes the host, so a loop's wall time a conv is the host's.
    The two give the same output. An op call's overhead is half a pair's difference (a
    conv is two op calls); an eager int8 forward's is that times its op calls
    (repvgg_a0 52, rexnet1_0x 88)."""
    import statistics

    import torch

    from holocron_tpu_torch.kernels import int8_conv as K

    gen = torch.Generator(device=device).manual_seed(SEED + 140)
    c = 64
    x = torch.randn(1, 8, 8, c, generator=gen, device=device).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (1, 1, c, c), generator=gen, device=device, dtype=torch.int8)
    w_packed = K.pack_weights(w_q)
    w_scale = torch.rand(c, generator=gen, device=device) / 127 / c
    bias = torch.randn(c, generator=gen, device=device).to(torch.bfloat16)
    s_x = (x.float().abs().max() / 127).reshape(1)

    def through_ops():
        return K.quantized_conv(x, s_x, w_q, w_scale, bias, out_dtype=torch.bfloat16, w_packed=w_packed)

    def direct():
        x_q = K._pitched_view(K._quantize_launch(x, s_x), c)
        return K._launch(x_q, w_q, w_packed, s_x, w_scale, bias, 1, 0, 1, torch.bfloat16, 1)

    if not torch.equal(through_ops(), direct()):
        fail("int8_op_dispatch: the ops' output differs from the direct launches'")
    for _ in range(200):
        through_ops()
        direct()
    us = {"ops": [], "direct": []}
    for i in range(pairs):
        for name in ("ops", "direct") if i % 2 == 0 else ("direct", "ops"):
            fn = through_ops if name == "ops" else direct
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            us[name].append((time.perf_counter() - t0) * 1e6 / calls)
    diffs = [a - b for a, b in zip(us["ops"], us["direct"])]
    per_call = statistics.median(diffs) / 2
    line = {"phase": "int8_op_dispatch", "shape": [1, 8, 8, c], "pairs": pairs, "calls": calls,
            "ops_us_per_conv": us["ops"], "direct_us_per_conv": us["direct"], "diff_us_per_conv": diffs,
            "op_call_us_median": per_call, "op_call_us_range": [min(diffs) / 2, max(diffs) / 2],
            "eager_forward_ms": {"repvgg_a0": per_call * 52 / 1e3, "rexnet1_0x": per_call * 88 / 1e3}}
    emit(line)
    return line


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
    from holocron_tpu_torch.bench import naturalistic_batch

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


DARKNETS = (("darknet24", 22413386), ("darknet19", 19827626), ("darknet53", 40595178),
            ("cspdarknet53", 26627434), ("cspdarknet53_mish", 26627434))


def phase_darknet_zoo(device, batch: int = 32, size: int = 224, num_classes: int = 10, iters: int = 10) -> None:
    """One eval forward of each darknet at full width, in float32 and bf16, as
    ``phase_resnet_zoo`` (channels_last, default BN statistics, random weights from the
    seed, cuDNN's heuristics): each model's parameter count at 10 classes must equal
    ``tests/test_models_classification.py:144-147``'s, its logits must be finite."""
    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.bench import naturalistic_batch

    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    x = naturalistic_batch(gen, batch, size, device)
    x16 = x.to(torch.bfloat16)
    rows = {}
    benchmark, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, False
    try:
        for arch, expected in DARKNETS:
            model = getattr(models, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                          device=device)
            params = sum(p.numel() for p in model.parameters())
            if params != expected:
                fail(f"{arch}: {params} parameters, expected {expected}")
            model = model.to(memory_format=torch.channels_last).eval()
            with torch.no_grad():
                ref = model(x)
                check_logits(ref, batch, num_classes, f"{arch} float32")
                model = model.to(torch.bfloat16)
                out = model(x16)
                check_logits(out, batch, num_classes, f"{arch} bf16")
                ms = cuda_ms(lambda: model(x16), iters)
            rows[arch] = {"params": params, "bf16_vs_f32_max_abs": float((out.float() - ref).abs().max()),
                          "logit_absmax_f32": float(ref.abs().max()),
                          "bf16_top1_vs_f32": float((out.argmax(-1) == ref.argmax(-1)).float().mean()),
                          "bf16_ms": ms, "bf16_img_per_s": batch / (ms / 1e3)}
            del model, ref, out
    finally:
        torch.backends.cudnn.benchmark = benchmark
    torch.cuda.synchronize()
    emit({"phase": "darknet_zoo", "image_size": size, "batch": batch, "models": rows})


def int8_geometries(qm) -> list:
    """The distinct int8 conv geometries of a quantized model, each with its count of
    layers: ``[C, O, kernel, stride, route, layers]``."""
    from holocron_tpu_torch.kernels.int8_conv import conv_route
    from holocron_tpu_torch.quant import QuantizedConv2d

    geoms = {}
    for m in qm.modules():
        if isinstance(m, QuantizedConv2d):
            kh, _, c, o = m.kernel_q.shape
            key = (c, o, kh, m.stride[0], conv_route(c, o, m.groups))
            geoms[key] = geoms.get(key, 0) + 1
    return [[*k, n] for k, n in sorted(geoms.items())]


def _yolov4_for_serving(device, num_classes: int, size: int, gen):
    """yolov4 as ``detection_serving`` serves it: 608 px, ``pretrained_backbone=False``,
    random weights from the seed, the three zero-initialized prediction convs drawn
    He-normal from the seed too (at zero every box, score and objectness is the same
    and the int8 gate compares nothing), BN statistics adapted in train mode on 4
    naturalistic batches of 8 (the raw forward: the detector's train-mode call needs
    ground truth), then eval, channels_last."""
    import torch

    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.models import detection
    from holocron_tpu_torch.nn.init import kaiming_normal_

    weights = torch.Generator().manual_seed(SEED)
    model = detection.yolov4(pretrained_backbone=False, num_classes=num_classes, generator=weights, device="cpu")
    with torch.no_grad():
        for conv in model.head.pred_convs():
            kaiming_normal_(conv.weight, generator=weights)
    model = model.to(device=device, memory_format=torch.channels_last)
    model.train()
    with torch.no_grad():
        for _ in range(4):
            model.raw(naturalistic_batch(gen, 8, size, device))
    return model.eval()


def detection_ladder(raw_ref: list, raw_q: list, nms_thresh: float, score_thresh: float) -> tuple:
    """``scripts/quant_accuracy.py:215-294``'s protocol on cached raw outputs of both
    forms: walk the thresholds (objectness, score) (0.5, the model's score threshold) ->
    (0.25, 0.01) -> (0.1, 1e-3) -> (0, the rank threshold that lets about 2 boxes an image
    pass in the reference form) until the reference form gives at least 0.5 detections
    an image, with the same thresholds for both forms; then returns both forms'
    detection lists, batch by batch, and the rung taken."""
    import numpy as np
    import torch

    from holocron_tpu_torch.models.detection import detections_to_list, post_process

    scores = torch.cat([(s.float().amax(-1) * o.float()).flatten() for _, o, s in raw_ref])
    per_image = raw_ref[0][1].shape[1]
    rank_t = float(np.quantile(scores.cpu().numpy(), max(0.0, 1.0 - 2.0 / per_image)))

    def dets(raw, obj_t, score_t):
        return [detections_to_list(post_process(*(t.float() for t in r), nms_thresh, score_t, obj_thresh=obj_t))
                for r in raw]

    for obj_t, score_t in ((0.5, score_thresh), (0.25, 0.01), (0.1, 1e-3), (0.0, rank_t)):
        ref = dets(raw_ref, obj_t, score_t)
        if np.mean([len(d["boxes"]) for batch in ref for d in batch]) >= 0.5:
            break
    return ref, dets(raw_q, obj_t, score_t), {"obj_thresh": obj_t, "score_thresh": score_t}


def phase_detection_serving(device, size: int = 608, num_classes: int = 80, batches=(8, 32), iters: int = 10) -> tuple:
    """yolov4 served at full width (608 px, 80 classes; its anchors are normalized to
    608): bf16 and selective int8 (calibrated on a batch of 8 in float32, float
    remainder in bf16; post-processing in float32) at batch 8 and 32, eager and through
    ``deploy_forward``'s graphs: the raw forward, ``post_process`` alone (its graph
    captured on the raw outputs) and both together; device ms from CUDA events, wall
    ms a synchronized call, img/s; at batch 8 the NMS pass (``greedy_keep``) alone and
    the idle share of the graph and eager forms (``torch.profiler``). Each replay's
    boxes, scores, labels and keep masks must equal the eager ones bit for bit. The
    box-F1 gate (:func:`detection_ladder`, then ``measure_agreement_detection`` at
    ``score_thresh=0.0``) on 2 held-out naturalistic batches of 8; a gate read on no
    detection fails. Then each int8 conv's input at batch 8, hooked in the eager int8
    forward, is held against the plain versions (``_int8_case_holds``), the 255-wide
    prediction convs among them. Last, yolov1 at 448 px and yolov2 at 416 px (20
    classes, bf16, batch 8, eager): raw forward + ``post_process`` ms, outputs finite.
    Returns the int8 kernels' launches the counters saw (eager forwards, warm-ups,
    captures)."""
    import functools

    import torch

    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.kernels import int8_conv as K
    from holocron_tpu_torch.models import detection
    from holocron_tpu_torch.models.core import deploy_forward
    from holocron_tpu_torch.models.detection import post_process
    from holocron_tpu_torch.models.detection._utils import greedy_keep
    from holocron_tpu_torch.quant import QuantizedConv2d, measure_agreement_detection, quantize_model

    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    model = _yolov4_for_serving(device, num_classes, size, gen)
    nms, score_t = model.rpn_nms_thresh, model.box_score_thresh
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    calib = naturalistic_batch(gen, 8, size, device)
    qm = quantize_model(model, calibration_batches=[calib], arch="yolov4").to(torch.bfloat16)
    n_int8 = sum(isinstance(m, QuantizedConv2d) for m in qm.modules())
    geoms = int8_geometries(qm)
    if n_int8 != 102 or any(g[4] != "wgmma" for g in geoms) or not any(g[1] == 255 for g in geoms):
        fail(f"yolov4: {n_int8} int8 convs at {geoms}; expected 102 on wgmma, the prediction convs 255 wide")
    xs = {b: naturalistic_batch(gen, b, size, device).to(torch.bfloat16) for b in batches}
    candidates = 3 * sum((size // s) ** 2 for s in (8, 16, 32))  # 22,743 at 608 px
    torch.cuda.synchronize()

    def full(fwd, x):
        return post_process(*(t.float() for t in fwd(x)), nms, score_t)

    forms = {"bf16": model_bf16, "int8": qm}
    reset_counts()
    records, graphs = {}, {}
    with torch.no_grad():
        for name, m in forms.items():
            for b, x in xs.items():
                raw = m.raw(x)
                if not all(bool(torch.isfinite(t).all()) for t in raw) or raw[0].shape[:2] != (b, candidates):
                    fail(f"yolov4 {name}: raw outputs not finite or of shape {raw[0].shape}")
            graphs[name] = {"raw": deploy_forward(m, batches, size, forward=m.raw),
                            "full": deploy_forward(m, batches, size, forward=functools.partial(full, m.raw))}
        for name, m in forms.items():
            rec = {}
            for b, x in xs.items():
                eager_raw = m.raw(x)
                eager = post_process(*(t.float() for t in eager_raw), nms, score_t)
                got = {k: v.clone() for k, v in graphs[name]["full"](x).items()}
                for key in ("boxes", "scores", "labels", "keep"):
                    if not torch.equal(got[key], eager[key]):
                        fail(f"yolov4 {name} batch {b}: the replay's {key} differ from the eager forward's")
                raw32 = tuple(t.float() for t in eager_raw)
                calls = {"raw": (lambda: m.raw(x), lambda: graphs[name]["raw"](x)),
                         "post_process": (lambda: post_process(*raw32, nms, score_t),
                                          captured(lambda: post_process(*raw32, nms, score_t))),
                         "raw_post_process": (lambda: full(m.raw, x), lambda: graphs[name]["full"](x))}
                row = {"kept": int(eager["keep"].sum())}
                for what, (eager_fn, graph_fn) in calls.items():
                    for mode, fn in (("eager", eager_fn), ("graph", graph_fn)):
                        device_ms = cuda_ms(fn, iters)
                        t0 = time.perf_counter()
                        for _ in range(iters):
                            fn()
                            torch.cuda.synchronize()
                        row[f"{what}_{mode}"] = {"device_ms": device_ms,
                                                  "wall_ms": (time.perf_counter() - t0) * 1e3 / iters}
                row["img_per_s_graph"] = b / (row["raw_post_process_graph"]["device_ms"] / 1e3)
                row["img_per_s_raw_graph"] = b / (row["raw_graph"]["device_ms"] / 1e3)
                if b == batches[0]:
                    k = min(1024, raw32[0].shape[1])
                    boxes = eager["boxes"]
                    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=device)
                    row["nms_pass_graph_ms"] = graph_ms(lambda: greedy_keep(boxes, valid, nms), iters=1,
                                                        replays=iters)
                    row["nms_candidates"] = k
                    row["post_process_share_graph"] = (row["post_process_graph"]["device_ms"]
                                                       / row["raw_post_process_graph"]["device_ms"])
                    row["nms_share_of_post_process"] = row["nms_pass_graph_ms"] / row["post_process_graph"]["device_ms"]
                    for mode, fn in (("graph", graphs[name]["full"]), ("eager", functools.partial(full, m.raw))):
                        prof = profile_forward(fn, x, steps=3, top=5)
                        row[f"profile_{mode}"] = {"kernel_ms": prof["kernel_ms"], "kernel_launches":
                                                  prof["kernel_launches"], "idle": 1 - prof["kernel_ms"] /
                                                  row["raw_post_process_" + mode]["wall_ms"], "top": prof["top"]}
                rec[f"batch{b}"] = row
            records[name] = rec

        # the box-F1 gate on 2 held-out batches of 8
        held = [naturalistic_batch(gen, 8, size, device).to(torch.bfloat16) for _ in range(2)]
        raw_ref = [model_bf16.raw(x) for x in held]
        raw_q = [qm.raw(x) for x in held]
        dets_ref, dets_q, rung = detection_ladder(raw_ref, raw_q, nms, score_t)
        ref_iter, q_iter = iter(dets_ref), iter(dets_q)
        gate = measure_agreement_detection(lambda _: next(ref_iter), lambda _: next(q_iter), held, score_thresh=0.0)
        if not gate["dets_per_image_ref"] > 0:
            fail(f"yolov4 int8 gate read on no detection: {gate}")

        # every int8 conv's input at batch 8 against the plain versions
        cases = []
        hooks = [m.register_forward_pre_hook(lambda mod, args, n=n: cases.append((n, mod, args[0])))
                 for n, m in qm.named_modules() if isinstance(m, QuantizedConv2d)]
        try:
            qm.raw(xs[batches[0]])
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        launches = int8_launches()  # the path's; the checks below launch more
        if not launches["int8_conv"] or not launches["int8_quantize"] or launches["int8_conv_general"]:
            fail(f"yolov4 int8: the path launched {launches}, expected the wgmma conv and the quantization")
        max_err = {"wgmma": 0.0, "general": 0.0}
        for n, m, xin in cases:
            _int8_case_holds(f"yolov4 {n}", K.conv_route(m.kernel_q.shape[2], m.kernel_q.shape[3], m.groups),
                             xin.permute(0, 2, 3, 1), m.activation_scale(xin), m.kernel_q, m.kernel_packed,
                             m.w_scale, m.bias, m.stride, m.padding, m.dilation, m.groups, max_err)
        if len(cases) != n_int8:
            fail(f"yolov4 int8 check: hooked {len(cases)} inputs, expected {n_int8}")

        others = {}
        for arch, osize, kwargs in (("yolov1", 448, {"input_shape": (3, 448, 448)}), ("yolov2", 416, {})):
            m = getattr(detection, arch)(pretrained_backbone=False, num_classes=20, generator=torch.Generator()
                                         .manual_seed(SEED), device=device, **kwargs)
            m = m.to(memory_format=torch.channels_last).eval().to(torch.bfloat16)
            x = naturalistic_batch(gen, 8, osize, device).to(torch.bfloat16)
            out = full(m.raw, x)
            raw = m.raw(x)
            if not all(bool(torch.isfinite(t).all()) for t in raw):
                fail(f"{arch}: raw outputs not finite")
            others[arch] = {"image_size": osize, "candidates": int(raw[0].shape[1]), "kept_b8": int(out["keep"].sum()),
                            "raw_post_process_eager_ms": cuda_ms(lambda: full(m.raw, x), iters),
                            "raw_eager_ms": cuda_ms(lambda: m.raw(x), iters)}
            del m
    torch.cuda.synchronize()
    last = f"batch{batches[-1]}"
    emit({"phase": "detection_serving", "model": "yolov4", "image_size": size, "num_classes": num_classes,
          "int8_convs": n_int8, "int8_geometries": geoms, "forms": records,
          "int8_over_bf16_raw_graph": (records["int8"][last]["img_per_s_raw_graph"]
                                       / records["bf16"][last]["img_per_s_raw_graph"]),
          "gate": {**gate, **rung},
          "int8_checked_layers": len(cases), "int8_max_abs_err_bf16": max_err["wgmma"], "others": others,
          "launches": launches})
    return launches


def _synthetic_detection_batches(gen, rng, count: int, batch: int, size: int, num_classes: int, device,
                                 max_boxes: int = 50, padded: bool = True):
    """Random uint8 NCHW images (channels_last, made on the device from a seed) and 1 to
    6 boxes an image from a numpy seed (relative xyxy, as ``tests/test_models_detection.py``'s
    ``_make_targets``), padded to ``max_boxes`` on the host, or as the list of dicts the
    evaluation takes."""
    import numpy as np
    import torch

    from holocron_tpu_torch.models.detection import pad_targets

    out = []
    for _ in range(count):
        x = torch.randint(0, 256, (batch, 3, size, size), generator=gen, device=device, dtype=torch.uint8)
        gts = []
        for _ in range(batch):
            n = int(rng.integers(1, 7))
            boxes = rng.random((n, 4), dtype=np.float32)
            boxes[:, :2] *= boxes[:, 2:]
            gts.append({"boxes": boxes, "labels": rng.integers(0, num_classes, size=(n,))})
        out.append((x.contiguous(memory_format=torch.channels_last), pad_targets(gts, max_boxes) if padded else gts))
    return out


def _detection_trainer(device, arch: str, train, val, size: int, num_classes: int):
    """The detection reference's trainer (``references/detection/train.py:178-213``):
    ``pretrained_backbone=False``, amp, TAdam (no weight decay), ImageNet ``input_norm``
    on the uint8 batches."""
    import torch

    from holocron_tpu_torch.models import detection
    from holocron_tpu_torch.optim import TAdam
    from holocron_tpu_torch.trainer import DetectionTrainer

    kwargs = {"input_shape": (3, size, size)} if arch == "yolov1" else {}
    model = getattr(detection, arch)(pretrained_backbone=False, num_classes=num_classes,
                                     generator=torch.Generator().manual_seed(SEED), device=device, **kwargs)
    model = model.to(memory_format=torch.channels_last)
    return DetectionTrainer(model, train, val, None, TAdam, device=device, amp=True, input_norm=IMAGENET,
                            output_file=str(ROOT / "holocron_tpu_torch" / "_build" / "smoke_detection.pt"))


def _losses_and_grads(trainer, x, target) -> tuple:
    """The four losses of one train-mode forward (amp, as the step) and whether every
    parameter's gradient of their sum is finite; the parameters are not updated."""
    import torch

    trainer.model.train()
    losses = trainer._call_model(trainer._input_prep(x), trainer.model.pad(target, trainer.device))
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(sum(v.float() for v in losses.values()), params, allow_unused=True)
    finite = all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    return {k: float(v.detach()) for k, v in losses.items()}, finite


def phase_detection_training(device, batch: int = 8, steps: int = 4) -> None:
    """yolov2 at 416 px (20 classes) in the detection reference's trainer: an epoch of
    4 synthetic batches through ``fit_n_epochs`` (onecycle, lr 1e-4), which ends with
    ``evaluate()`` on one batch; the four losses of a step and the finiteness of every
    gradient with padded target slots; ms a step from CUDA events over ``steps`` steps
    after 2, peak memory, the kernels a step (``Trainer.profile``). Then yolov4 at 608
    px (80 classes) for 2 timed steps: ms a step, peak memory, losses and gradients
    finite (the CIoU path with padded slots). Fails on a loss or gradient that is not
    finite."""
    import numpy as np
    import torch

    rows = {}
    for arch, size, num_classes, n_steps in (("yolov2", 416, 20, steps), ("yolov4", 608, 80, 2)):
        gen = torch.Generator(device=device).manual_seed(SEED + 32)
        rng = np.random.default_rng(SEED)
        train = _synthetic_detection_batches(gen, rng, 4, batch, size, num_classes, device)
        val = _synthetic_detection_batches(gen, rng, 1, batch, size, num_classes, device, padded=False)
        trainer = _detection_trainer(device, arch, train, val, size, num_classes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row = {"image_size": size, "batch": batch, "num_classes": num_classes, "amp": True, "optimizer": "TAdam",
               "max_boxes": 50, "padded_slots": int((~train[0][1]["mask"]).sum())}
        if arch == "yolov2":
            evaluated = []
            trainer.on_epoch_end = evaluated.append
            trainer.fit_n_epochs(1, 1e-4)
            row["eval"] = evaluated[0]
            if trainer._opt.param_groups[0]["count"] != len(train):
                fail(f"{arch} training: {trainer._opt.param_groups[0]['count']} updates, expected {len(train)}")
        else:
            trainer._reset_opt(1e-4)
        losses, finite = _losses_and_grads(trainer, *train[0])
        if not finite or not all(map(math.isfinite, losses.values())):
            fail(f"{arch} training: losses {losses}, gradients finite: {finite}")
        row["losses"], row["grads_finite"] = losses, finite
        row["train_step_ms"] = time_train_steps(trainer, train, n_steps)
        row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if not all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters()):
            fail(f"{arch} training: parameters not finite after the steps")
        if arch == "yolov2":
            prof = summarize_profile(trainer.profile(num_steps=2), 2)
            row["kernel_launches_per_step"] = prof["kernel_launches"]
            row["profile"] = {k: prof[k] for k in ("host_ms", "kernel_ms", "idle", "top")}
        rows[arch] = row
        del trainer, train, val
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"phase": "detection_training", "models": rows})


SEGMENTATION_ZOO = ("unet", "unetp", "unetpp", "unet3p", "unet2", "unet_tvvgg11", "unet_tvresnet34", "unet_rexnet13")


def phase_segmentation_zoo(device, batch: int = 32, size: int = 256, num_classes: int = 21, iters: int = 5) -> None:
    """One eval forward of each of the eight segmentation factories at full width
    (``scripts/bench_zoo.py:12,37-40``'s 256 px and batch 32; 21 classes, default BN
    statistics, random weights from the seed), in float32 and bf16, channels_last:
    logits of shape ``(batch, 21, 256, 256)`` and finite, bf16 against float32, bf16 ms
    a forward (CUDA events). cuDNN's heuristics pick the algorithms (``cudnn.benchmark``
    off, as in ``phase_resnet_zoo``)."""
    import torch

    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.models import segmentation

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    x = naturalistic_batch(gen, batch, size, device)
    x16 = x.to(torch.bfloat16)
    rows = {}
    benchmark, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, False
    try:
        for arch in SEGMENTATION_ZOO:
            model = getattr(segmentation, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                                device=device)
            model = model.to(memory_format=torch.channels_last).eval()
            with torch.no_grad():
                ref = model(x)
                check_masks(ref, batch, num_classes, size, f"{arch} float32")
                model = model.to(torch.bfloat16)
                out = model(x16)
                check_masks(out, batch, num_classes, size, f"{arch} bf16")
                ms = cuda_ms(lambda: model(x16), iters, warmup=1)
            rows[arch] = {"params": sum(p.numel() for p in model.parameters()),
                          "bf16_vs_f32_max_abs": float((out.float() - ref).abs().max()),
                          "logit_absmax_f32": float(ref.abs().max()),
                          "bf16_pixels_vs_f32": float((out.argmax(1) == ref.argmax(1)).float().mean()),
                          "bf16_ms": ms, "bf16_img_per_s": batch / (ms / 1e3)}
            del model, ref, out
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = benchmark
    torch.cuda.synchronize()
    emit({"phase": "segmentation_zoo", "image_size": size, "batch": batch, "num_classes": num_classes,
          "models": rows})


def check_masks(out, batch: int, num_classes: int, size: int, what: str) -> None:
    import torch

    if tuple(out.shape) != (batch, num_classes, size, size) or not bool(torch.isfinite(out).all()):
        fail(f"{what}: expected finite logits of shape {(batch, num_classes, size, size)}, got {tuple(out.shape)}")


UNET3P_INT8 = 33  # unet3p's convs of 64 input channels or more: all but the 3-channel stem


def phase_segmentation_serving(device, size: int = 256, num_classes: int = 21, batches=(8, 32),
                               iters: int = 10) -> tuple:
    """unet3p served at full width (256 px, 21 classes, the segmentation CLI's
    defaults): BN statistics adapted in train mode on 4 naturalistic batches of 32, then
    bf16 and selective int8 (calibrated on a batch of 32 in float32, float remainder in
    bf16): 33 int8 convs, every one on the ``wgmma`` route (the 320- and 1024-wide
    inputs, the biased ``FSAggreg`` convs, the 21-wide head), pinned as
    ``phase_serving`` pins its splits, each launching the quantization and the conv once
    an eager forward. Each form at batch 8 and 32, eager and through ``deploy_forward``'s
    graphs: device ms a call (CUDA events), wall ms a synchronized call, img/s; every
    replay equal to the eager forward bit for bit. The int8 gate
    (``measure_agreement_segmentation``: pixel agreement and mean mask IoU against bf16)
    on 2 held-out batches of 32. ``torch.profiler`` over the batch-32 forward of each
    form, graph and eager: kernel ms, launches, idle share, top kernels. Returns the
    int8 model, the bf16 model and the batch-32 input for :func:`check_int8`, and the
    int8 kernels' launches the counters saw (eager forwards, warm-ups and captures)."""
    import torch

    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.kernels.int8_conv import conv_route
    from holocron_tpu_torch.models import segmentation
    from holocron_tpu_torch.models.core import deploy_forward
    from holocron_tpu_torch.quant import QuantizedConv2d, measure_agreement_segmentation, quantize_model

    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    model = segmentation.unet3p(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED), device=device)
    model = model.to(memory_format=torch.channels_last)
    model.train()
    with torch.no_grad():
        for _ in range(4):
            model(naturalistic_batch(gen, batches[-1], size, device))
    model.eval()
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    calib = naturalistic_batch(gen, batches[-1], size, device)
    qm = quantize_model(model, calibration_batches=[calib], arch="unet3p").to(torch.bfloat16)
    layers = [m for m in qm.modules() if isinstance(m, QuantizedConv2d)]
    geoms = int8_geometries(qm)
    routes = [conv_route(m.kernel_q.shape[2], m.kernel_q.shape[3], m.groups) for m in layers]
    if (len(layers) != UNET3P_INT8 or routes.count("wgmma") != UNET3P_INT8
            or not any(g[1] == num_classes for g in geoms) or not any(m.bias is not None for m in layers)):
        fail(f"unet3p: {len(layers)} int8 convs at {geoms}, routes {set(routes)}; expected {UNET3P_INT8} on wgmma, "
             f"a {num_classes}-wide head and biased convs among them")
    xs = {b: naturalistic_batch(gen, b, size, device).to(torch.bfloat16) for b in batches}
    held = [naturalistic_batch(gen, batches[-1], size, device).to(torch.bfloat16) for _ in range(2)]
    del calib
    torch.cuda.synchronize()

    forms = {"bf16": model_bf16, "int8": qm}
    reset_counts()
    records, graphs = {}, {}
    with torch.no_grad():
        for name, m in forms.items():
            for b, x in xs.items():
                check_masks(m(x), b, num_classes, size, f"unet3p {name} batch {b}")
        eager_launches = int8_launches()
        expected = len(batches) * UNET3P_INT8
        if eager_launches != {"int8_conv": expected, "int8_quantize": expected, "int8_conv_general": 0}:
            fail(f"unet3p int8: the eager forwards launched {eager_launches}, expected {expected} of each")
        for name, m in forms.items():
            graphs[name] = deploy_forward(m, batches, size)
            rec = {}
            for b, x in xs.items():
                eager = m(x)
                if not torch.equal(graphs[name](x), eager):
                    fail(f"unet3p {name} batch {b}: the replay differs from the eager forward")
                row = {}
                for mode, fn in (("eager", lambda: m(x)), ("graph", lambda: graphs[name](x))):
                    device_ms = cuda_ms(fn, iters)
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn()
                        torch.cuda.synchronize()
                    row[mode] = {"device_ms": device_ms, "wall_ms": (time.perf_counter() - t0) * 1e3 / iters,
                                 "img_per_s": b / (device_ms / 1e3)}
                rec[f"batch{b}"] = row
            records[name] = rec
        launches = int8_launches()
        if not launches["int8_conv"] or not launches["int8_quantize"] or launches["int8_conv_general"]:
            fail(f"unet3p int8: the path launched {launches}, expected the wgmma conv and the quantization")
        gate = measure_agreement_segmentation(model_bf16, qm, held)
        x32 = xs[batches[-1]]
        profiles = {f"{name}_{mode}": profile_forward(fn, x32, steps=3, top=8)
                    for name in forms for mode, fn in (("graph", graphs[name]), ("eager", forms[name]))}
    torch.cuda.synchronize()
    last = f"batch{batches[-1]}"
    emit({"phase": "segmentation_serving", "model": "unet3p", "image_size": size, "num_classes": num_classes,
          "params": sum(p.numel() for p in model.parameters()), "int8_convs": len(layers),
          "int8_geometries": geoms, "forms": records,
          "int8_over_bf16_graph": (records["bf16"][last]["graph"]["device_ms"]
                                   / records["int8"][last]["graph"]["device_ms"]),
          "gate": gate, "profiles": profiles, "launches": launches})
    del graphs
    return qm, model_bf16, x32, launches


def phase_segmentation_training(device, size: int = 256, batch: int = 16, num_classes: int = 21,
                                timed_steps: int = 4) -> None:
    """The segmentation CLI's ``main()`` in this process, on the card:
    ``fake --arch unet3p -b 16 --crop-size 256 --fake-samples 64 --epochs 1 --amp`` (AdamP,
    onecycle, cross-entropy ignoring 255; an epoch of 4 batches from spawned loader
    workers, then ``evaluate()``), its output on stderr: every step's loss and the
    evaluation must be finite, 4 updates applied. Then, in the CLI's trainer, ms a
    train step over a steady window of ``timed_steps`` (CUDA events) on batches made on
    the device (a fifth of the pixels 255), with bf16 compute (``--amp``) and in the
    CLI's float32 default (cuDNN's heuristics, no autotuning), each with its peak
    memory; and the kernels a step and the idle share from ``Trainer.profile``."""
    import contextlib

    import torch

    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.references.segmentation import train
    from holocron_tpu_torch.trainer import SegmentationTrainer

    ckpt = ROOT / "holocron_tpu_torch" / "_build" / "smoke_segmentation.pt"
    args = train.parse_args(["fake", "--arch", "unet3p", "-b", str(batch), "--crop-size", str(size),
                             "--fake-samples", "64", "--epochs", "1", "--amp", "--num-classes", str(num_classes),
                             "--device", str(device), "--output-file", str(ckpt)])
    losses, evaluated = [], []
    step, evaluate = SegmentationTrainer._run_step_async, SegmentationTrainer.evaluate

    def recorded_step(self, x, target):
        losses.append(step(self, x, target))
        return losses[-1]

    def recorded_eval(self, *a, **kw):
        evaluated.append(evaluate(self, *a, **kw))
        return evaluated[-1]

    SegmentationTrainer._run_step_async, SegmentationTrainer.evaluate = recorded_step, recorded_eval
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            trainer = train.main(args)
    finally:
        SegmentationTrainer._run_step_async, SegmentationTrainer.evaluate = step, evaluate
        ckpt.unlink(missing_ok=True)
    cli_s = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    steps = 64 // batch
    if (len(losses) != steps or not all(map(math.isfinite, losses)) or len(evaluated) != 1
            or not all(map(math.isfinite, evaluated[0].values())) or trainer._opt.param_groups[0]["count"] != steps):
        fail(f"segmentation training: losses {losses}, evaluate {evaluated}, "
             f"{trainer._opt.param_groups[0]['count']} updates; expected {steps} finite losses and updates")

    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    batches = []
    for _ in range(2):
        target = torch.randint(0, num_classes, (batch, size, size), generator=gen, device=device)
        target[torch.rand(target.shape, generator=gen, device=device) < 0.2] = 255
        batches.append((naturalistic_batch(gen, batch, size, device), target))
    windows = {}
    benchmark = torch.backends.cudnn.benchmark
    try:
        for amp in (True, False):
            # the float32 convs take cuDNN's heuristics: autotuning every forward and
            # backward shape of unet3p in float32 without TF32 took about 9 minutes on
            # the H100
            torch.backends.cudnn.benchmark = benchmark and amp
            trainer.amp = amp
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_train_steps(trainer, batches, timed_steps)
            windows["bf16" if amp else "float32"] = {"train_step_ms": ms, "train_img_per_s": batch / (ms / 1e3),
                                                     "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    finally:
        torch.backends.cudnn.benchmark = benchmark
    trainer.amp = True
    trainer.train_loader, trainer.val_loader = batches, None  # the CLI's loaders stop their workers
    prof = summarize_profile(trainer.profile(num_steps=2), 2)
    if not all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters()):
        fail("segmentation training: parameters not finite after the steps")
    torch.cuda.synchronize()
    emit({"phase": "segmentation_training", "model": "unet3p", "image_size": size, "batch": batch,
          "num_classes": num_classes, "optimizer": "AdamP", "sched": "onecycle", "cli_seconds": cli_s,
          "losses": losses, "eval": evaluated[0], "steps": windows,
          "kernel_launches_per_step": prof["kernel_launches"],
          "profile": {k: prof[k] for k in ("host_ms", "kernel_ms", "idle", "top")}})


MORE_ZOO = ("mobileone_s0", "mobileone_s1", "mobileone_s2", "mobileone_s3", "convnext_atto", "convnext_femto",
            "convnext_pico", "convnext_nano", "convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
            "convnext_xl")


def adapt_bn(model, gen, batches: int, batch: int, size: int, device) -> None:
    """BN statistics adapted to the naturalistic input in train mode (``bench.py:123-124``),
    then eval mode."""
    import torch

    from holocron_tpu_torch.bench import naturalistic_batch

    model.train()
    with torch.no_grad():
        for _ in range(batches):
            model(naturalistic_batch(gen, batch, size, device))
    model.eval()


def phase_classification_zoo_more(device, batch: int = 32, size: int = 224, num_classes: int = 10,
                                  iters: int = 5) -> None:
    """An f32 and a bf16 eval forward of mobileone_s0-s3 and convnext_atto-xl at full
    width, 224 px, batch 32 (channels_last, random weights from the seed, cuDNN's
    heuristics as in ``resnet_zoo``): ms a forward of each, bf16 top-1 against f32.
    MobileOne in both forms: BN adapted on 4 naturalistic batches, the train form
    timed, then ``reparametrize()`` (the drift of the deploy form against the train
    form in float32, under 1e-3 of the logits' scale) and the deploy form timed."""
    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.bench import naturalistic_batch

    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    x = naturalistic_batch(gen, batch, size, device)
    x16 = x.to(torch.bfloat16)
    rows = {}
    benchmark, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, False
    try:
        for arch in MORE_ZOO:
            model = getattr(models, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                          device=device).to(memory_format=torch.channels_last).eval()
            row = {"params": sum(p.numel() for p in model.parameters())}
            forms = ["eval"]
            if hasattr(model, "reparametrize"):
                adapt_bn(model, gen, 4, batch, size, device)
                forms = ["train_form", "deploy_form"]
            with torch.no_grad():
                for form in forms:
                    if form == "deploy_form":
                        model.reparametrize()
                        model = model.to(memory_format=torch.channels_last)
                    ref = model(x)
                    check_logits(ref, batch, num_classes, f"{arch} {form} float32")
                    if form == "train_form":
                        train_ref = ref
                    elif form == "deploy_form":
                        drift = float((train_ref - ref).abs().max())
                        scale = max(1.0, float(train_ref.abs().max()))
                        if drift > 1e-3 * scale:
                            fail(f"{arch}: reparametrization drift {drift} > 1e-3 * {scale}")
                        row["reparam_drift_f32"] = drift
                    f32_ms = cuda_ms(lambda: model(x), iters)
                    model16 = copy.deepcopy(model).to(torch.bfloat16)
                    out = model16(x16)
                    check_logits(out, batch, num_classes, f"{arch} {form} bf16")
                    bf16_ms = cuda_ms(lambda: model16(x16), iters)
                    row[form] = {"f32_ms": f32_ms, "bf16_ms": bf16_ms, "bf16_img_per_s": batch / (bf16_ms / 1e3),
                                 "bf16_vs_f32_max_abs": float((out.float() - ref).abs().max()),
                                 "logit_absmax_f32": float(ref.abs().max()),
                                 "bf16_top1_vs_f32": float((out.argmax(-1) == ref.argmax(-1)).float().mean())}
                    del model16, out
            rows[arch] = row
            del model
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = benchmark
    torch.cuda.synchronize()
    emit({"phase": "classification_zoo_more", "image_size": size, "batch": batch, "models": rows})


def draw_layer_scales(model, gen) -> None:
    """Every LayerScale weight drawn from a normal of std 0.1 (seeded): at its 1e-6
    initialization each ConvNeXt block adds about 1e-6 of its branch, and the int8 gate
    would measure the stem, the downsamples and the head alone."""
    import torch

    from holocron_tpu_torch.models.classification.convnext import LayerScale

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen, device=m.weight.device) * 0.1)


def phase_serving_graphs(device, arch: str, qm, model_bf16, x, r8, phase: str, iters: int = 20) -> dict:
    """The bf16 and int8 forms of a served model through ``deploy_forward``'s CUDA graphs
    at batch 8 and 256: each replay equal to the eager forward bit for bit, and device
    ms a call (CUDA events) eager against graph. Returns the int8 kernels' launches the
    counters saw (eager forwards, warm-ups and captures)."""
    import torch

    from holocron_tpu_torch.models.core import deploy_forward

    size = x.shape[-1]
    reset_counts()
    rows = {}
    with torch.no_grad():
        for name, m in (("bf16", model_bf16), ("int8", qm)):
            graph = deploy_forward(m, (r8.shape[0], x.shape[0]), size)
            for xb in (r8, x):
                eager = m(xb)
                if not torch.equal(graph(xb), eager):
                    fail(f"{arch} {name} batch {xb.shape[0]}: the replay differs from the eager forward")
                rows[f"{name}_b{xb.shape[0]}"] = {"eager_ms": cuda_ms(lambda: m(xb), iters),
                                                  "graph_ms": cuda_ms(lambda: graph(xb), iters)}
            del graph
    torch.cuda.synchronize()
    launches = int8_launches()
    if not launches["int8_conv"] or not launches["int8_quantize"] or launches["int8_conv_general"]:
        fail(f"{arch} graphs: the int8 path launched {launches}, expected the wgmma conv and the quantization")
    b = x.shape[0]
    emit({"phase": phase, "model": arch, "image_size": size, "replays_equal_eager": True, "forms": rows,
          "int8_over_bf16_graph": rows[f"bf16_b{b}"]["graph_ms"] / rows[f"int8_b{b}"]["graph_ms"],
          "launches": launches})
    return launches


def int8_sums_by_kernel(rows: list, model: str) -> dict:
    """A served model's ``check_int8_geometry`` rows summed over its layers (each
    geometry times its count of layers) by kernel shape: ``1x1`` and, where there are
    any, ``2x2_s2``; ``int_mm_ms`` is None where a row has no such time."""
    keys = ("route_ms", "conv_ms", "quantize_ms", "cudnn_bf16_ms", "int_mm_ms", "bound_ms")
    out = {}
    for row in rows:
        kh, _, _, _ = row["w_hwio"]
        kind = f"{kh}x{kh}" + (f"_s{row['stride'][0]}" if row["stride"][0] != 1 else "")
        rec = out.setdefault(kind, {"layers": 0, **dict.fromkeys(keys, 0.0)})
        rec["layers"] += row["count"]
        for k in keys:
            rec[k] = None if rec[k] is None or row.get(k) is None else rec[k] + row["count"] * row[k]
    return {"model": model, **out}


def convnext_profile(qm, model_bf16, x) -> dict:
    """The batch-256 forwards under ``torch.profiler``, each form's device time of its
    12 costliest kernels split by kind: the LayerNorms, the GELUs, cuDNN's depthwise
    7x7 convs (``conv2d_c1_k1``), the int8 kernels, the other convs and GEMMs, and the
    rest (elementwise: the convs' bias adds, LayerScale, the residual adds)."""
    prof = {form: profile_forward(fn, x, steps=3, top=12) for form, fn in (("bf16", model_bf16), ("int8", qm))}
    for rec in prof.values():
        kinds = dict.fromkeys(("layer_norm", "gelu", "depthwise", "int8", "conv_or_gemm", "other"), 0.0)
        for name, ms, _ in rec["top"]:
            low = name.lower()
            kind = ("layer_norm" if "layer_norm" in low else "gelu" if "gelu" in low
                    else "depthwise" if "conv2d_c1_k1" in low else "int8" if "int8" in low
                    else "conv_or_gemm" if any(k in low for k in ("conv", "gemm", "nvjet", "xmma", "cutlass"))
                    else "other")
            kinds[kind] += ms
        rec["top12_by_kind_ms"] = kinds
    return prof


def _write_image_folder(root, classes: int = 10, per_class: int = 8, pngs: int = 3, val_per_class: int = 4) -> None:
    """An Imagenette-shaped folder of random-noise images around 300 x 250, JPEG, with
    ``pngs`` PNGs in the training split, from the seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 60)
    for split, count in (("train", per_class), ("val", val_per_class)):
        for c in range(classes):
            folder = root / split / f"n{c:08d}"
            folder.mkdir(parents=True)
            for i in range(count):
                h, w = int(rng.integers(220, 280)), int(rng.integers(270, 330))
                coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
                img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
                if split == "train" and c < pngs and i == 0:
                    img.save(folder / f"{i}.png")
                else:
                    img.save(folder / f"{i}.jpg", quality=90)


def _cli_run(argv: list, what: str, task: str = "classification") -> dict:
    """A training CLI's ``main()`` (``task``: classification or detection) in this
    process on the card, its output on stderr: each train step's loss (on the device,
    read after the run), CUDA events around each step, the host time spent waiting on
    the loader before each step (from the end of one step's launch to the start of the
    next), the evaluations (each value finite where it is a number: a detection error
    rate with no denominator is None) and the peak memory."""
    import contextlib
    import importlib

    import torch

    from holocron_tpu_torch import trainer as trainers

    train = importlib.import_module(f"holocron_tpu_torch.references.{task}.train")
    Trainer = trainers.DetectionTrainer if task == "detection" else trainers.ClassificationTrainer
    losses, events, waits, evaluated = [], [], [], []
    step, evaluate = Trainer._run_step_async, Trainer.evaluate
    last = [None]

    def recorded_step(self, x, target):
        t0 = time.perf_counter()
        if last[0] is not None:
            waits.append(t0 - last[0])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(self, x, target))
        end.record()
        events.append((start, end))
        last[0] = time.perf_counter()
        return losses[-1]

    def recorded_eval(self, *a, **kw):
        evaluated.append(evaluate(self, *a, **kw))
        return evaluated[-1]

    Trainer._run_step_async, Trainer.evaluate = recorded_step, recorded_eval
    output = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(output):
            trainer = train.main(train.parse_args(argv))
    finally:
        Trainer._run_step_async, Trainer.evaluate = step, evaluate
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(output.getvalue(), file=sys.stderr)
    if any(not loss.is_cuda for loss in losses) or any(p.device.type != "cuda" for p in trainer.model.parameters()):
        fail(f"{what}: the model or the step left the card")
    losses = [float(v) for v in losses]
    if not all(map(math.isfinite, losses)) or len(evaluated) != 1 \
            or not all(math.isfinite(v) for v in evaluated[0].values() if v is not None):
        fail(f"{what}: losses {losses}, evaluate {evaluated}; expected finite losses and one finite evaluation")
    return {"trainer": trainer, "losses": losses, "eval": evaluated[0], "cli_seconds": seconds,
            "step_ms_after_first": [s.elapsed_time(e) for s, e in events[1:]],
            "loader_wait_ms_after_first": [w * 1e3 for w in waits], "stdout": output.getvalue(),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_classification_cli(device, workers: int = 8) -> None:
    """The classification CLI's ``main()`` run in this process on the card, twice.

    (a) On an Imagenette-shaped folder written to a temporary directory (10 classes, 8
    images a class around 300 x 250 for training, 3 of them PNG, and 4 a class for
    evaluation): ``--arch convnext_tiny --opt adan --amp -b 32 --random-erase 0.1
    --epochs 1``, the default crop (176), Mixup (0.2) and label smoothing (0.1), ``-j
    8`` spawned loader workers: an epoch of 2 steps and the evaluation, then
    ``--test-only --resume`` on the checkpoint it wrote, whose evaluation must agree
    with the first (the same accuracies, the loss within 1e-3 relative). The decode
    route the CLI printed (native or PIL: PIL wherever a PNG is in the folder, and on a
    machine without libjpeg), ms of the second step (CUDA events), the host's wait on
    the loader before it and its share of the two, peak memory, and a steady window of
    4 steps of the CLI's trainer on 176 px batches made on the device.
    (b) ``fake --arch mobileone_s1 --opt lars -b 32 --fake-samples 128`` at the default
    176 px: 4 steps and the evaluation.

    Every loss finite and on the card, the model on the card, one evaluation a run."""
    import tempfile

    import torch

    from holocron_tpu_torch.bench import naturalistic_batch

    records = {}
    with tempfile.TemporaryDirectory(prefix="holocron_cli_") as tmp:
        root = Path(tmp) / "imagenette"
        _write_image_folder(root)
        ckpt = Path(tmp) / "convnext_tiny.pt"
        argv = [str(root), "--arch", "convnext_tiny", "--opt", "adan", "--amp", "-b", "32", "--random-erase", "0.1",
                "--epochs", "1", "-j", str(workers), "--device", str(device), "--output-file", str(ckpt)]
        run = _cli_run(argv, "classification_cli (a)")
        route = "native" if "native decoder" in run["stdout"] else "PIL" if "Decoding with PIL" in run["stdout"] else None
        if route is None or not ckpt.exists() or len(run["losses"]) != 2:
            fail(f"classification_cli (a): {len(run['losses'])} steps, expected 2; a decode route printed and a "
                 f"checkpoint written ({run['stdout'][-400:]})")
        resumed = _cli_run([*argv, "--test-only", "--resume", str(ckpt)], "classification_cli (a) --test-only")
        again, first = resumed["eval"], run["eval"]
        if (again["acc1"], again["acc5"]) != (first["acc1"], first["acc5"]) \
                or abs(again["val_loss"] - first["val_loss"]) > 1e-3 * abs(first["val_loss"]):
            fail(f"classification_cli (a): --test-only --resume evaluated {again}, the run {first}")
        gen = torch.Generator(device=device).manual_seed(SEED + 61)
        batches = [(naturalistic_batch(gen, 32, 176, device),
                    torch.softmax(torch.randn(32, 10, generator=gen, device=device), -1)) for _ in range(2)]
        torch.cuda.reset_peak_memory_stats()
        window_ms = time_train_steps(run["trainer"], batches, 4)
        wait, busy = sum(run["loader_wait_ms_after_first"]), sum(run["step_ms_after_first"])
        records["a"] = {"model": "convnext_tiny", "optimizer": "Adan", "decode_route": route, "batch": 32,
                        "image_size": 176, "losses": run["losses"], "eval": first, "resumed_eval": again,
                        "cli_seconds": run["cli_seconds"], "test_only_seconds": resumed["cli_seconds"],
                        "step_ms_after_first": run["step_ms_after_first"],
                        "loader_wait_ms_after_first": run["loader_wait_ms_after_first"],
                        "loader_share_after_first": wait / (wait + busy) if wait + busy else None,
                        "peak_memory_gib": run["peak_memory_gib"], "window_step_ms": window_ms,
                        "window_img_per_s": 32 / (window_ms / 1e3),
                        "window_peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        del run, resumed
        torch.cuda.empty_cache()
        run = _cli_run(["fake", "--arch", "mobileone_s1", "--opt", "lars", "-b", "32", "--fake-samples", "128",
                        "--epochs", "1", "-j", str(workers), "--device", str(device),
                        "--output-file", str(Path(tmp) / "mobileone_s1.pt")], "classification_cli (b)")
        if len(run["losses"]) != 4:
            fail(f"classification_cli (b): {len(run['losses'])} steps, expected 4")
        records["b"] = {"model": "mobileone_s1", "optimizer": "LARS", "data": "fake", "batch": 32, "image_size": 176,
                        "losses": run["losses"], "eval": run["eval"], "cli_seconds": run["cli_seconds"],
                        "step_ms_after_first": run["step_ms_after_first"],
                        "loader_wait_ms_after_first": run["loader_wait_ms_after_first"],
                        "peak_memory_gib": run["peak_memory_gib"]}
        del run
    torch.cuda.empty_cache()
    emit({"phase": "classification_cli", "workers": workers, **records})


OPTIM_ZOO = ("lars", "ralars", "adan", "ademamix", "lookahead_adamp", "scout_adamp")


def phase_optim_zoo(device, batch: int = 64, size: int = 224, num_classes: int = 10, steps: int = 4) -> None:
    """4 train steps of mobileone_s1 (batch 64, 224 px, amp, label-smoothed
    cross-entropy) under each of LARS (momentum 0.9), RaLars, Adan, AdEMAMix, and
    Lookahead and Scout around AdamP (sync every 2 steps, so each syncs twice), each on
    a fresh model from the seed: finite losses, ms a step (CUDA events over the last 3),
    the kernels one step launches and those of the optimizer's step alone
    (``torch.profiler``, one step after the timed ones), and no optimizer step reading
    the device (``torch.cuda.set_sync_debug_mode("error")`` around each)."""
    import functools

    import torch

    from holocron_tpu_torch import optim

    factories = {
        "lars": functools.partial(optim.LARS, momentum=0.9),
        "ralars": optim.RaLars,
        "adan": optim.Adan,
        "ademamix": optim.AdEMAMix,
        "lookahead_adamp": lambda groups, lr: optim.Lookahead(optim.AdamP(groups, lr), sync_period=2),
        "scout_adamp": lambda groups, lr: optim.Scout(optim.AdamP(groups, lr), sync_period=2),
    }
    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    batches = [(naturalistic_batch_u8(gen, batch, size, device),
                torch.randint(0, num_classes, (batch,), generator=gen, device=device)) for _ in range(2)]
    rows = {}
    for name in OPTIM_ZOO:
        trainer = make_trainer(device, batches, None, num_classes, "mobileone_s1")
        trainer.optimizer, trainer.skip_nan_loss, trainer.gradient_acc, trainer.grad_clip = factories[name], False, 1, None
        trainer._reset_opt(1e-3)
        opt_step = trainer._opt.step

        def checked_step(closure=None, opt_step=opt_step):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return opt_step(closure)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        trainer._opt.step = checked_step
        losses, events = [], []
        for i in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(trainer._run_step_async(*batches[i % 2]))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        losses = [float(v) for v in losses]
        if not all(map(math.isfinite, losses)):
            fail(f"optim_zoo {name}: losses {losses}")
        step_kernels = _kernel_launches(lambda: trainer._run_step_async(*batches[0]))
        params = [p for group in trainer._opt.param_groups for p in group["params"]]
        for p in params:
            p.grad = torch.zeros_like(p)
        opt_kernels = _kernel_launches(trainer._opt.step)
        for p in params:
            p.grad = None
        rows[name] = {"losses": losses, "step_ms": sum(s.elapsed_time(e) for s, e in events[1:]) / (steps - 1),
                      "kernel_launches_per_step": step_kernels, "optimizer_step_kernel_launches": opt_kernels,
                      "parameters": len(params)}
        del trainer
        torch.cuda.empty_cache()
    emit({"phase": "optim_zoo", "model": "mobileone_s1", "batch": batch, "image_size": size, "amp": True,
          "steps": steps, "sync_debug_mode_in_step": "error", "optimizers": rows})


def _write_detection_folder(root, train: int = 16, val: int = 8) -> None:
    """A detection folder (``<root>/{train,val}/{images,labels}``) of random-noise images
    of sizes around 300 to 500 px, JPEG and PNG, with 1 to 5 relative boxes each in JSON,
    from the seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 80)
    for split, count in (("train", train), ("val", val)):
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir(parents=True)
        for i in range(count):
            h, w = int(rng.integers(280, 520)), int(rng.integers(280, 520))
            coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
            img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
            img.save(root / split / "images" / (f"{i}.png" if i % 4 == 3 else f"{i}.jpg"), **({} if i % 4 == 3 else {"quality": 90}))
            n = int(rng.integers(1, 6))
            boxes = np.sort(rng.random((n, 2, 2)), axis=1).transpose(0, 2, 1).reshape(n, 4)[:, [0, 2, 1, 3]]
            (root / split / "labels" / f"{i}.json").write_text(
                json.dumps({"boxes": boxes.tolist(), "labels": rng.integers(0, 20, n).tolist()}))


def phase_detection_cli(device, workers: int = 8) -> None:
    """The detection CLI's ``main()`` in this process on the card at the JAX CLI's
    defaults (yolov2, darknet19, 20 classes, 416 px, batch 8, 50 boxes a target, TAdam at
    1e-4 under onecycle) with ``--amp`` and ``-j 8`` spawned loader workers.

    (a) ``fake`` with 32 samples, one epoch: 4 steps and the evaluation on 8. (b) A
    folder written to a temporary directory (16 training and 8 evaluation images of
    varied sizes, a quarter PNG, with JSON labels): one epoch of 2 steps and the
    evaluation, then ``--test-only --resume`` on the checkpoint it wrote, whose printed
    error rates must be the run's. (c) ``--check-setup`` on ``fake`` (10 steps on one
    batch, ``-j 0``): the loss must fall. Printed: ms of the steps after the first (CUDA
    events) and the host's wait on the loader before each, ms a step of the CLI's
    trainer on device batches (a steady window of 4), peak memory, the evaluations'
    error rates. Every loss finite and on the card, the model on the card."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    from holocron_tpu_torch.references.detection import train

    common = ["--amp", "-j", str(workers), "--device", str(device), "--epochs", "1"]
    records = {}
    with tempfile.TemporaryDirectory(prefix="holocron_det_cli_") as tmp:
        tmp = Path(tmp)
        run = _cli_run(["fake", *common, "--output-file", str(tmp / "fake.pt")], "detection_cli (a)", "detection")
        if len(run["losses"]) != 4:
            fail(f"detection_cli (a): {len(run['losses'])} steps, expected 4")
        gen = torch.Generator(device=device).manual_seed(SEED + 81)
        batches = _synthetic_detection_batches(gen, np.random.default_rng(SEED + 81), 2, 8, 416, 20, device)
        torch.cuda.reset_peak_memory_stats()
        window_ms = time_train_steps(run["trainer"], batches, 4)
        model = run["trainer"].model
        records["a_fake"] = {
            "arch": "yolov2", "batch": 8, "image_size": 416, "num_classes": 20, "samples": 32,
            "losses": run["losses"], "eval": run["eval"], "cli_seconds": run["cli_seconds"],
            "step_ms_after_first": run["step_ms_after_first"],
            "loader_wait_ms_after_first": run["loader_wait_ms_after_first"], "peak_memory_gib": run["peak_memory_gib"],
            "window_step_ms_device_batches": window_ms,
            "window_peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "backbone_frozen_bn": any(type(m).__name__ == "FrozenBatchNorm2d" for m in model.backbone.modules())}
        del run, model, batches
        torch.cuda.empty_cache()

        _write_detection_folder(tmp / "voc")
        ckpt = tmp / "folder.pt"
        argv = [str(tmp / "voc"), *common, "--output-file", str(ckpt)]
        run = _cli_run(argv, "detection_cli (b)", "detection")
        if len(run["losses"]) != 2 or not ckpt.exists():
            fail(f"detection_cli (b): {len(run['losses'])} steps, expected 2, and a checkpoint")
        resumed = _cli_run([*argv, "--test-only", "--resume", str(ckpt)], "detection_cli (b) --test-only", "detection")
        printed = [line for line in resumed["stdout"].splitlines() if line.startswith("Loc error")]
        from holocron_tpu_torch.trainer import DetectionTrainer

        if printed != [DetectionTrainer._eval_metrics_str(run["eval"])]:
            fail(f"detection_cli (b): --test-only --resume evaluated {resumed['eval']} ({printed}), the run "
                 f"{run['eval']}")
        records["b_folder"] = {
            "train_images": 16, "val_images": 8, "losses": run["losses"], "eval": run["eval"],
            "resumed_eval_printed": printed[0], "cli_seconds": run["cli_seconds"],
            "test_only_seconds": resumed["cli_seconds"], "step_ms_after_first": run["step_ms_after_first"],
            "loader_wait_ms_after_first": run["loader_wait_ms_after_first"], "peak_memory_gib": run["peak_memory_gib"]}
        del run, resumed
        torch.cuda.empty_cache()

        output = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(output):
            trainer = train.main(train.parse_args(["fake", "--amp", "-j", "0", "--device", str(device), "--check-setup",
                                                   "--output-file", str(tmp / "setup.pt")]))
        seconds = time.perf_counter() - t0
        print(output.getvalue(), file=sys.stderr)
        line = next((x for x in output.getvalue().splitlines() if x.startswith("overfit-one-batch losses")), None)
        if line is None or any(p.device.type != "cuda" for p in trainer.model.parameters()):
            fail(f"detection_cli (c): no check-setup line, or the model left the card: {output.getvalue()[-400:]}")
        first, last = (float(v) for v in line.split(":")[1].split("->"))
        if not (math.isfinite(first) and math.isfinite(last) and last < first):
            fail(f"detection_cli (c): check-setup losses {first} -> {last}, expected a fall")
        records["c_check_setup"] = {"steps": 10, "first_loss": first, "last_loss": last, "seconds": seconds}
        del trainer
    torch.cuda.empty_cache()
    emit({"phase": "detection_cli", "workers": workers, **records})


def phase_pretrained(device) -> None:
    """Released-checkpoint loading on the card, from files written here with
    ``torch.save`` and read through ``file://`` URLs (``$HOLOCRON_CACHE_DIR`` a temporary
    directory for the phase): a seeded rexnet1_0x built with ``checkpoint=`` (the file's
    real sha256) gives the saved model's logits bit for bit (deterministic cuDNN); a
    darknet19 file loads into yolov2's backbone under ``key_filter="features."``, the
    backbone equal to the file and the rest of the detector as drawn; a wrong sha256
    leaves ``pretrained_loaded`` False and the drawn weights."""
    import hashlib
    import os
    import tempfile

    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.models.core import cudnn_settings
    from holocron_tpu_torch.models.utils import _checkpoint, load_pretrained_params

    saved_env = os.environ.get("HOLOCRON_CACHE_DIR")
    row = {}
    with tempfile.TemporaryDirectory(prefix="holocron_pretrained_") as tmp, cudnn_settings(benchmark=False,
                                                                                          deterministic=True):
        tmp = Path(tmp)
        os.environ["HOLOCRON_CACHE_DIR"] = str(tmp / "cache")
        try:
            source = models.rexnet1_0x(generator=torch.Generator().manual_seed(SEED + 90), device=device).eval()
            path = tmp / "rexnet1_0x.pth"
            torch.save(source.state_dict(), path)
            digest = hashlib.sha256(path.read_bytes()).hexdigest()
            ckpt = _checkpoint("rexnet1_0x", path.as_uri(), 0.0, 0.0, digest, path.stat().st_size, 0)
            t0 = time.perf_counter()
            loaded = models.rexnet1_0x(checkpoint=ckpt, progress=False, device=device).eval()
            load_s = time.perf_counter() - t0
            x = torch.randn(8, 3, 224, 224, generator=torch.Generator(device=device).manual_seed(SEED + 91),
                            device=device)
            with torch.no_grad():
                equal = bool(torch.equal(loaded(x), source(x)))
            if not loaded.pretrained_loaded or not equal:
                fail(f"pretrained: rexnet1_0x from its file loaded {loaded.pretrained_loaded}, logits equal {equal}")
            row["rexnet1_0x"] = {"file_bytes": path.stat().st_size, "load_s": load_s, "logits_equal": equal}

            dark = models.darknet19(generator=torch.Generator().manual_seed(SEED + 92), device="cpu")
            dark_url = (tmp / "darknet19.pth").as_uri()
            torch.save(dark.state_dict(), tmp / "darknet19.pth")
            det = models.yolov2(pretrained_backbone=False, num_classes=20, device=device,
                                generator=torch.Generator().manual_seed(SEED + 93))
            drawn = {k: v.clone() for k, v in det.state_dict().items() if not k.startswith("backbone.")}
            load_pretrained_params(det, dark_url, key_filter="features.", key_replacement=("features.", "backbone."))
            state = det.state_dict()
            backbone = all(torch.equal(state[k.replace("features.", "backbone.", 1)], v.to(device))
                           for k, v in dark.state_dict().items() if k.startswith("features."))
            rest = all(torch.equal(state[k], v) for k, v in drawn.items())
            if not (det.pretrained_loaded and backbone and rest):
                fail(f"pretrained: darknet19 into yolov2's backbone: loaded {det.pretrained_loaded}, backbone equal "
                     f"{backbone}, the rest as drawn {rest}")
            row["yolov2_backbone"] = {"keys": sum(k.startswith("features.") for k in dark.state_dict()),
                                      "backbone_equal": backbone, "rest_as_drawn": rest}

            bad = _checkpoint("rexnet1_0x", path.as_uri(), 0.0, 0.0, "0" * 64, 0, 0)
            again = models.rexnet1_0x(checkpoint=bad, progress=False, device=device,
                                      generator=torch.Generator().manual_seed(SEED + 94))
            ref = models.rexnet1_0x(device=device, generator=torch.Generator().manual_seed(SEED + 94))
            kept = all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), ref.state_dict().values()))
            if again.pretrained_loaded or not kept:
                fail(f"pretrained: a sha256 mismatch loaded {again.pretrained_loaded}, kept the drawn weights {kept}")
            row["sha256_mismatch"] = {"pretrained_loaded": again.pretrained_loaded, "drawn_weights_kept": kept}
        finally:
            if saved_env is None:
                os.environ.pop("HOLOCRON_CACHE_DIR", None)
            else:
                os.environ["HOLOCRON_CACHE_DIR"] = saved_env
    torch.cuda.empty_cache()
    emit({"phase": "pretrained", **row})


REMAT_MODES = (False, True, "dots")


def phase_remat(device, batch: int = 128, size: int = 224, num_classes: int = 10, steps: int = 3) -> None:
    """resnet50 (batch 128, 224 px, amp, LAMB, the classification reference's step) under
    ``remat`` False, True and ``"dots"``, a fresh model from the seed each, 3 steps on the
    same batches: ms a step (CUDA events, after the first), peak memory. Held against
    ``False`` (bf16 compute, cuDNN free to pick its algorithms): the loss at every step
    within 1e-3 relative (the first comes from the forward alone, the later ones from
    the recomputed backward's updates, each 1-8% of the loss), the BN running means
    after the first step within 1e-3 relative (the recomputation's update undone), and
    the first update of each parameter within 1e-2 of its norm (the recomputed
    gradients under autocast)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 100)
    batches = synthetic_batches(gen, 2, batch, size, num_classes, device)
    rows, ref = {}, None
    for mode in REMAT_MODES:
        trainer = make_trainer(device, batches, None, num_classes, "resnet50", remat=mode)
        trainer._reset_opt(1e-3)
        # the parameters before and after the first step, copied to pinned host memory
        # in stream order: no host sync between the steps, no device memory
        params = [p for p in trainer.model.parameters() if p.requires_grad]
        before, after = ([torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in params] for _ in range(2))
        for h, p in zip(before, params):
            h.copy_(p.detach(), non_blocking=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, events = [], []
        for i in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(trainer._run_step_async(*batches[i % 2]))
            end.record()
            events.append((start, end))
            if i == 0:
                stats = [m.running_mean.clone() for m in trainer.model.modules()
                         if isinstance(m, torch.nn.BatchNorm2d)]
                for h, p in zip(after, params):
                    h.copy_(p.detach(), non_blocking=True)
        torch.cuda.synchronize()
        update = [a.float() - b.float() for a, b in zip(after, before)]
        losses = [float(v) for v in losses]
        if not all(map(math.isfinite, losses)):
            fail(f"remat {mode}: losses {losses}")
        if ref is None:
            ref = (losses, stats, update)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref[0]))
        stat_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-12)) for a, b in zip(stats, ref[1]))
        update_rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(update, ref[2]))
        if loss_rel > 1e-3 or stat_rel > 1e-3 or update_rel > 1e-2:
            fail(f"remat {mode}: losses {losses} against {ref[0]}, BN running means off by {stat_rel}, "
                 f"first updates off by {update_rel} of their norm")
        rows[str(mode)] = {"losses": losses, "step_ms_after_first": [s.elapsed_time(e) for s, e in events[1:]],
                           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "loss_rel_diff": loss_rel, "bn_running_mean_rel_diff": stat_rel,
                           "first_update_rel_diff": update_rel}
        del trainer, params, before, after
        torch.cuda.empty_cache()
    emit({"phase": "remat", "model": "resnet50", "batch": batch, "image_size": size, "amp": True,
          "optimizer": "LAMB", "modes": rows})


def phase_binary_trainer(device, batch: int = 128, size: int = 224, steps: int = 4) -> None:
    """``BinaryClassificationTrainer`` on rexnet1_0x with one output (amp, LAMB,
    ``BCEWithLogitsLoss``, whose ``reduction`` the top-loss collection sets to "none")
    over 4 naturalistic batches with 0/1 float targets (batch 128, rexnet_training's
    shapes, whose convolutions cuDNN has tuned by then): the steps, ``evaluate()`` on 2
    batches (``val_loss`` and ``acc`` finite), and ``top_losses`` (``plot_top_losses``'s
    collection, without the plot): 12 samples, highest loss first."""
    import functools

    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.optim import LAMB
    from holocron_tpu_torch.trainer import BinaryClassificationTrainer

    gen = torch.Generator(device=device).manual_seed(SEED + 110)
    data = [(naturalistic_batch(gen, batch, size, device),
             torch.randint(0, 2, (batch,), generator=gen, device=device).float()) for _ in range(steps + 2)]
    model = models.rexnet1_0x(num_classes=1, generator=torch.Generator().manual_seed(SEED), device=device)
    trainer = BinaryClassificationTrainer(model.to(memory_format=torch.channels_last), data[:steps], data[steps:],
                                          torch.nn.BCEWithLogitsLoss(),
                                          functools.partial(LAMB, weight_decay=5e-5), device=device, amp=True)
    trainer._reset_opt(1e-3)
    losses = [float(trainer._run_step_async(x, y)) for x, y in data[:steps]]
    metrics = trainer.evaluate()
    top = trainer.top_losses(IMAGENET[0], IMAGENET[1])
    if not all(map(math.isfinite, [*losses, *metrics.values()])) or set(metrics) != {"val_loss", "acc"} \
            or len(top["losses"]) != 12 or not all(top["losses"][:-1] >= top["losses"][1:]):
        fail(f"binary_trainer: losses {losses}, evaluate {metrics}, top losses {top['losses']}")
    emit({"phase": "binary_trainer", "model": "rexnet1_0x", "outputs": 1, "batch": batch, "image_size": size,
          "losses": losses, "eval": metrics, "top_losses": top["losses"].tolist(), "top_probs": top["probs"].tolist(),
          "top_targets": top["targets"].tolist()})
    del trainer
    torch.cuda.empty_cache()


def phase_export(device) -> dict:
    """``python -m holocron_tpu_torch.export``'s ``main()`` on the card: repvgg_a0 at
    batch 1 and 224 px in bf16 and in int8 (bf16 remainder, per-call scales), and
    yolov2 at 416 px in float32 with its post-processing; each exported, saved, loaded
    and run against the eager module (float32 within 1e-5; int8 equal bit for bit; bf16's
    difference, if any, printed). The int8 graph must hold both ops once a layer (26),
    and its runs launch the kernels (counted). Printed: export time, graph nodes, file
    size."""
    import tempfile

    from holocron_tpu_torch import export

    reset_counts()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="holocron_export_") as tmp:
        for name, argv in (("repvgg_a0_bf16", ["repvgg_a0", "--dtype", "bfloat16"]),
                           ("repvgg_a0_int8", ["repvgg_a0", "--dtype", "bfloat16", "--quantize"]),
                           ("yolov2_post_process", ["yolov2", "--size", "416", "--num-classes", "20"])):
            out = Path(tmp) / f"{name}.pt2"
            rec = export.main(export.parse_args([*argv, "--device", str(device), "--output", str(out)]))
            rows[name] = {k: rec[k] for k in ("export_s", "nodes", "custom_ops", "file_bytes", "max_abs_err", "equal",
                                               "outputs")}
    ops = rows["repvgg_a0_int8"]["custom_ops"]
    launches = int8_launches()
    if set(ops.values()) != {26} or not launches["int8_conv"] or not launches["int8_quantize"]:
        fail(f"export: the int8 graph holds {ops}, expected 26 of each op; launches {launches}")
    if not rows["repvgg_a0_int8"]["equal"]:
        fail(f"export: the loaded int8 program differs from eager by {rows['repvgg_a0_int8']['max_abs_err']}")
    emit({"phase": "export", "forms": rows, "launches": launches})
    return launches


ZOO_ONE_A_FAMILY = ("repvgg_a0", "mobileone_s0", "rexnet1_0x", "resnet50", "darknet19", "convnext_atto", "unet3p",
                    "yolov2")


def phase_latency_and_zoo(device, zoo_batch: int = 32, it: int = 20) -> dict:
    """``eval_latency``'s ``main()`` for rexnet1_0x at batch 8 and 256, bf16 and
    ``--quantize`` (the captured graph; device mean ms, the host's round trip, img/s),
    then ``bench_zoo``'s ``main()`` over one architecture of each family (repvgg_a0,
    mobileone_s0, rexnet1_0x, resnet50, darknet19, convnext_atto, unet3p, yolov2; bf16,
    batch 32, each task's size, ``--it 20``). Fails if a row it asked for is an error
    row."""
    from holocron_tpu_torch import bench_zoo, eval_latency

    reset_counts()
    latency = []
    for batch in (8, 256):
        for quantize in (False, True):
            argv = ["rexnet1_0x", "--batch", str(batch), "--dtype", "bfloat16", "--device", str(device)]
            latency.append(eval_latency.main(eval_latency.parse_args(argv + (["--quantize"] if quantize else []))))
    launches = int8_launches()
    rows = bench_zoo.main(bench_zoo.parse_args(["--tasks", "classification", "segmentation", "detection", "--archs",
                                                *ZOO_ONE_A_FAMILY, "--batch", str(zoo_batch), "--it", str(it),
                                                "--device", str(device)]))
    errors = [r for r in rows if "error" in r]
    if errors or len(rows) != len(ZOO_ONE_A_FAMILY):
        fail(f"latency_and_zoo: {len(rows)} rows, errors {errors}")
    if not launches["int8_conv"] or not launches["int8_quantize"]:
        fail(f"latency_and_zoo: the int8 runs launched {launches}")
    emit({"phase": "latency_and_zoo", "eval_latency": latency, "zoo": rows, "launches": launches})
    return launches


def phase_profiling(device, batch: int = 256, size: int = 224) -> None:
    """``utils.profiling.device_op_summary`` on rexnet1_0x's bf16 eval forward at batch
    256, against ``profile_forward``'s kernel ms of the same forward (within 5%) and
    against the forward's device time from CUDA events, unprofiled: kernels run one
    after another on one stream, so their sum lies within 0.85-1.03 of it (the rest is
    the gaps between them, and the clock's drift between the readings). The top kernels
    by device time."""
    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.utils.profiling import device_op_summary

    model = models.rexnet1_0x(generator=torch.Generator().manual_seed(SEED), device=device).eval()
    model = model.to(torch.bfloat16).to(memory_format=torch.channels_last)
    x = naturalistic_batch(torch.Generator(device=device).manual_seed(SEED + 120), batch, size, device)
    x = x.to(torch.bfloat16)
    summary = device_op_summary(model, x, iters=20)
    reference = profile_forward(model, x)
    with torch.no_grad():
        event_ms = cuda_ms(lambda: model(x), 20)
    rel = abs(summary["ms_per_iter"] - reference["kernel_ms"]) / reference["kernel_ms"]
    share = summary["ms_per_iter"] / event_ms
    if rel > 0.05 or not 0.85 <= share <= 1.03:
        fail(f"profiling: device_op_summary {summary['ms_per_iter']} ms against profile_forward "
             f"{reference['kernel_ms']} ms and CUDA events' {event_ms} ms a forward")
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profiling", "model": "rexnet1_0x", "batch": batch, "dtype": "bfloat16",
          "device_op_summary_ms": summary["ms_per_iter"], "wall_ms": summary["wall_ms_per_iter"],
          "profile_forward_kernel_ms": reference["kernel_ms"], "profile_forward_profiles": reference["profiles"],
          "profile_forward_pad_kernels_missing": reference["pad_kernels_missing"],
          "rel_diff": rel, "cuda_event_ms": event_ms, "kernel_share_of_event_ms": share,
          "top": [[name[:90], us / 20 / 1e3] for name, us in top]})
    del model
    torch.cuda.empty_cache()


def _kernel_launches(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("train_step."))


def naturalistic_batch_u8(gen, batch: int, size: int, device):
    """A naturalistic batch as uint8 images (the trainer normalizes them with
    ``input_norm``)."""
    import torch

    from holocron_tpu_torch.bench import naturalistic_batch

    x = naturalistic_batch(gen, batch, size, device)
    return (x * 40 + 128).clamp(0, 255).to(torch.uint8).contiguous(memory_format=torch.channels_last)


def int8_entries(launches: list, replays_seen: dict, records: list, grouped: list) -> list:
    """The ``kernels`` line's entries of the int8 kernels: launches the counters saw,
    summed over the paths' runs (the four classification serving paths, the bench, the
    captured deploy forward's warm-ups, captures and eager forwards, the service's
    captures, yolov4's eager forwards, warm-ups and captures in ``detection_serving``,
    unet3p's in ``segmentation_serving``, mobileone_s1's and convnext_tiny's eager
    forwards, warm-ups and captures in their serving phases, the exported int8
    repvgg_a0's eager and loaded runs in ``export``, and ``eval_latency``'s int8
    rexnet1_0x in ``latency_and_zoo``);
    apart from them, ``replay_launches_seen``: the launches ``torch.profiler`` saw in
    the counted graph replays of ``deploy_graph_profile`` (a replay makes no call a
    counter sees);
    the wgmma conv's and the quantization's times and bounds summed over one batch-256
    forward of each serving model (each geometry times its count of layers; each conv's bound
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
                "launches": sum(run[name] for run in launches), "replay_launches_seen": replays_seen[name],
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

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
    dqm, dmodel_bf16, dx, _, darknet_launches = timed(phase_serving, device, "darknet53", 49, 49, "darknet_serving")
    inv_launches = timed(phase_involution, device)
    timed(phase_training, device)
    timed(phase_arch_training, device)
    timed(phase_arch_training, device, "rexnet1_0x", "rexnet_training")
    inv_train = timed(phase_involution_train, device)
    add2d_launches = timed(phase_add2d, device)
    timed(phase_resnet_zoo, device)
    timed(phase_darknet_zoo, device)
    timed(phase_nn_catalog, device)
    bench_launches = timed(phase_bench, device)
    graph_forms, graph_launches = timed(phase_deploy_graph, device, qm, model_bf16)
    service_launches = timed(phase_service, device)
    detection_launches = timed(phase_detection_serving, device)
    timed(phase_detection_training, device)
    timed(phase_segmentation_zoo, device)
    sqm, smodel_bf16, sx, segmentation_launches = timed(phase_segmentation_serving, device)
    timed(phase_segmentation_training, device)
    mqm, mmodel_bf16, mx, mr8, mobileone_launches = timed(phase_serving, device, "mobileone_s1", 21, 21,
                                                          "mobileone_serving")
    mobileone_graph_launches = timed(phase_serving_graphs, device, "mobileone_s1", mqm, mmodel_bf16, mx, mr8,
                                     "mobileone_serving_graphs")
    cqm, cmodel_bf16, cx, cr8, convnext_launches = timed(phase_serving, device, "convnext_tiny", 39, 39,
                                                         "convnext_serving", prepare=draw_layer_scales)
    convnext_graph_launches = timed(phase_serving_graphs, device, "convnext_tiny", cqm, cmodel_bf16, cx, cr8,
                                    "convnext_serving_graphs")
    timed(phase_classification_zoo_more, device)
    timed(phase_classification_cli, device)
    timed(phase_optim_zoo, device)
    timed(phase_detection_cli, device)
    timed(phase_pretrained, device)
    timed(phase_remat, device)
    timed(phase_binary_trainer, device)
    export_launches = timed(phase_export, device)
    latency_launches = timed(phase_latency_and_zoo, device)
    inv = timed(check_involution, device)
    inv_bwd = timed(check_involution_bwd, device)
    add = timed(check_add2d, device)
    i8 = timed(check_int8, device, qm, model_bf16, x)
    i8_resnet = timed(check_int8, device, rqm, rmodel_bf16, rx, "resnet50")
    i8_rexnet = timed(check_int8, device, xqm, xmodel_bf16, xx, "rexnet1_0x")
    timed(check_int8, device, dqm, dmodel_bf16, dx, "darknet53")
    timed(check_int8, device, sqm, smodel_bf16, sx, "unet3p")
    del sqm, smodel_bf16, sx
    for qmodel, bf16, xb, arch in ((mqm, mmodel_bf16, mx, "mobileone_s1"), (cqm, cmodel_bf16, cx, "convnext_tiny")):
        emit({"phase": "int8_sums_by_kernel", **int8_sums_by_kernel(timed(check_int8, device, qmodel, bf16, xb,
                                                                           arch)["rows"], arch)})
    timed(check_int8_service, device, graph_forms)
    emit({"phase": "rexnet_int8_by_kind", **rexnet_int8_by_kind(i8_rexnet["rows"])})
    grouped = timed(check_int8_grouped, device)
    timed(check_int8_dispatch, device)
    profile_launches, replays_seen = timed(phase_deploy_graph_profile, graph_forms)
    timed(phase_serving_profile, qm, model_bf16, x, r8)
    timed(phase_serving_profile, rqm, rmodel_bf16, rx, rr8, "resnet_serving_profile")
    timed(phase_serving_profile, xqm, xmodel_bf16, xx, xr8, "rexnet_serving_profile")
    timed(phase_serving_profile, mqm, mmodel_bf16, mx, mr8, "mobileone_serving_profile")
    emit({"phase": "convnext_serving_profile", "batch": cx.shape[0], **timed(convnext_profile, cqm, cmodel_bf16, cx)})
    timed(phase_profiling, device)

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
        *int8_entries([serving_launches, resnet_launches, rexnet_launches, darknet_launches, bench_launches,
                       graph_launches, service_launches, detection_launches, segmentation_launches,
                       mobileone_launches, mobileone_graph_launches, convnext_launches, convnext_graph_launches,
                       profile_launches, export_launches, latency_launches], replays_seen,
                      [i8, i8_resnet, i8_rexnet], grouped),
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
