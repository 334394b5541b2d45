#!/usr/bin/env python
"""Zoo-wide latency and throughput sweep to JSONL, the port of ``scripts/bench_zoo.py``:

    python -m holocron_tpu_torch.bench_zoo --out zoo.jsonl
    python -m holocron_tpu_torch.bench_zoo --tasks segmentation detection --batch 32

Every factory of the JAX script's lists through :mod:`.eval_latency`'s protocol in one
process (10 warm-up and 100 timed calls of the captured deploy forward, random weights
from a seed, ``reparametrize()`` first), one JSON line a model with the JAX script's
keys: ``compile_s`` is the seconds the quantization and the graph's capture took, and
``form`` is ``"graph"`` (every model is captured on the card, ``"eager"`` on the CPU;
the JAX script's ``const``/``args`` choice was a limit of a remote TPU compiler); a row
made on the card also names it, ``device``: its name and power limit from
``nvidia-smi``. A model that fails is written as an ``error`` row and the sweep goes on.
Runs on the card unless ``--device cpu``.
"""

import argparse
import json
import traceback
from typing import Dict, List, Optional

import torch

from .eval_latency import DTYPES, SEED, build_model, measure, timed_forward
from .utils.misc import device_label

__all__ = ["CLASSIFICATION", "DETECTION", "SEGMENTATION", "SIZES", "bench_one", "main"]

CLASSIFICATION = [
    "repvgg_a0", "repvgg_a1", "repvgg_a2", "repvgg_b0", "repvgg_b1", "repvgg_b2",
    "repvgg_b3",
    "mobileone_s0", "mobileone_s1", "mobileone_s2", "mobileone_s3",
    "rexnet1_0x", "rexnet1_3x", "rexnet1_5x", "rexnet2_0x", "rexnet2_2x",
    "resnet18", "resnet34", "resnet50", "resnet50d", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext101_32x8d",
    "res2net50_26w_4s", "sknet50", "sknet101", "sknet152", "tridentnet50",
    "pyconv_resnet50", "pyconvhg_resnet50",
    "darknet24", "darknet19", "darknet53", "cspdarknet53", "cspdarknet53_mish",
    "convnext_atto", "convnext_femto", "convnext_pico", "convnext_nano",
    "convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
    "convnext_xl",
]
SEGMENTATION = ["unet", "unet2", "unetp", "unetpp", "unet3p", "unet_tvvgg11", "unet_tvresnet34", "unet_rexnet13"]
DETECTION = ["yolov1", "yolov2", "yolov4"]

SIZES = {"classification": 224, "segmentation": 256, "detection": 416}


def bench_one(arch: str, task: str, batch: int, size: int, dtype: str, it: int, warmup: int, device,
              quantize: bool = False) -> Dict:
    """One model's row (``bench_zoo.py:43-124``)."""
    model = build_model(arch, device, DTYPES[dtype], size)
    x = torch.randn(batch, 3, size, size, generator=torch.Generator().manual_seed(SEED))
    x = x.to(device=device, dtype=DTYPES[dtype]).contiguous(memory_format=torch.channels_last)
    fwd, capture_s = timed_forward(model, arch, x, quantize)
    m = measure(fwd, x, it, warmup)
    n_params = sum(p.numel() for p in model.parameters())
    return {
        "arch": arch,
        "task": task,
        "batch": batch,
        "size": size,
        "dtype": dtype,
        "mean_ms": round(m["mean_ms"], 3),
        "img_per_sec": round(m["img_per_s"], 1),
        "params_m": round(n_params / 1e6, 2),
        "compile_s": round(capture_s, 1),
        "form": "graph" if x.device.type == "cuda" else "eager",
    }


def main(args) -> List[Dict]:
    """The sweep (``bench_zoo.py:127-154``); returns the rows it printed."""
    device = torch.device(args.device)
    plan = []
    if "classification" in args.tasks:
        plan += [(a, "classification") for a in CLASSIFICATION]
    if "segmentation" in args.tasks:
        plan += [(a, "segmentation") for a in SEGMENTATION]
    if "detection" in args.tasks:
        plan += [(a, "detection") for a in DETECTION]
    if args.archs:
        plan = [(a, t) for a, t in plan if a in args.archs]

    label = device_label(device) if device.type == "cuda" else None
    rows = []
    for arch, task in plan:
        size = args.size or SIZES[task]
        try:
            row = bench_one(arch, task, args.batch, size, args.dtype, args.it, args.warmup, device,
                            quantize=args.quantize)
            if args.quantize:
                row["quantized"] = True
            if label is not None:
                row["device"] = label
        except Exception as e:  # noqa: BLE001 — the sweep goes on past a model that fails
            row = {"arch": arch, "task": task, "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc()
        finally:
            if device.type == "cuda":
                torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)  # noqa: T201
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        rows.append(row)
    return rows


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--tasks", nargs="+", default=["classification"],
                   choices=["classification", "segmentation", "detection"])
    p.add_argument("--archs", nargs="*", default=None, help="subset filter")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=None, help="override per-task default size")
    p.add_argument("--it", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--quantize", action="store_true", help="selective int8 (holocron_tpu_torch.quant)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu")
    p.add_argument("--out", default=None, help="append JSONL results here")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
