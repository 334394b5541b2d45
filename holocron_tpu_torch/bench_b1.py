#!/usr/bin/env python
"""Batch-1 latency sweep against original Holocron's own latency table, the port of
``scripts/bench_b1.py``:

    python -m holocron_tpu_torch.bench_b1 --out zoo_h100_224_b1_bf16.jsonl
    python -m holocron_tpu_torch.bench_b1 --archs yolov1 yolov2 yolov4 unet unet2 unetp unetpp unet3p \\
        unet_tvvgg11 unet_tvresnet34 unet_rexnet13 --out zoo_h100_detseg_b1_bf16.jsonl

Original Holocron's README claims a batch-1 latency table over 25 classifiers (100
iterations, 224 px, RepVGG reparametrized) on an RTX 2070 Max-Q with an i7-10750H:
:data:`REFERENCE_B1_MS`. Each arch here runs in bf16 at batch 1, random weights from
seed 0, reparametrized where it can be, at ``--size`` (0: :data:`DEFAULT_SIZES`, else
224), through the captured deploy forward
(:func:`~holocron_tpu_torch.models.core.deploy_forward`, the counterpart of the JAX
script's jit with the weights closed over). One JSON row an arch, with the JAX script's
keys:

- ``device_ms``: the kernel time of a forward, summed from a ``torch.profiler`` trace
  by :func:`~holocron_tpu_torch.utils.profiling.device_op_summary` over ``--it``
  forwards (the JAX script's "XLA Ops" sum);
- ``queued_ms``: the host's time a forward with ``--it`` forwards queued and one
  synchronization at the end, what a pipelined caller sees;
- ``params_m``, ``ref_gpu_ms`` and ``ref_cpu_ms``, and ``speedup_vs_ref_gpu`` (the
  reference's GPU ms over ``device_ms``) where the reference has a figure and
  ``device_ms > 0``;
- ``form``: ``"graph"`` on the card (``"eager"`` on the CPU, where the host's
  operators stand in for the kernels); ``device``: the card's name and power limit;
- ``device_ms_exceeds_queued``: on the card, only where ``device_ms`` is more than 5%
  above ``queued_ms``. The kernels of a captured forward cannot take longer than the
  forwards queued back to back, so such a row's kernel sum is in doubt (the profiled
  forwards ran slower than the queued ones), and ``gen_bench_table --b1`` gives it no
  speedup.

An arch that fails is written as an ``error`` row and the sweep goes on. Runs on the
card unless ``--device cpu``, and raises where there is no card.
"""

import argparse
import json
import time
import traceback
from typing import Dict, List, Optional

import torch

from .eval_latency import SEED, _sync, build_model, timed_forward
from .utils.misc import device_label
from .utils.profiling import device_op_summary

__all__ = ["DEFAULT_SIZES", "REFERENCE_B1_MS", "bench_one", "main"]

# (gpu_ms, cpu_ms): original Holocron's README table, batch 1, 224 px, mean latency on
# an RTX 2070 Max-Q / i7-10750H (scripts/bench_b1.py:34-62)
REFERENCE_B1_MS = {
    "repvgg_a0": (3.14, 23.28),
    "repvgg_a1": (4.13, 29.61),
    "repvgg_a2": (7.35, 46.87),
    "repvgg_b0": (4.23, 33.16),
    "repvgg_b1": (12.48, 100.66),
    "repvgg_b2": (20.12, 155.90),
    "repvgg_b3": (24.94, 224.68),
    "rexnet1_0x": (6.01, 13.66),
    "rexnet1_3x": (6.43, 19.13),
    "rexnet1_5x": (6.46, 21.06),
    "rexnet2_0x": (6.75, 31.77),
    "rexnet2_2x": (6.92, 33.61),
    "sknet50": (11.40, 54.03),
    "sknet101": (23.55, 94.89),
    "sknet152": (69.81, 253.07),
    "tridentnet50": (16.62, 142.85),
    "res2net50_26w_4s": (9.25, 41.84),
    "resnet50d": (36.97, 36.97),
    "pyconv_resnet50": (20.03, 178.85),
    "pyconvhg_resnet50": (38.41, 301.03),
    "darknet24": (3.94, 29.39),
    "darknet19": (3.17, 26.36),
    "darknet53": (7.12, 53.20),
    "cspdarknet53": (6.41, 48.05),
    "cspdarknet53_mish": (6.88, 67.78),
}

# The detectors and segmenters at the reference's training resolutions (the reference
# publishes no latency for them; scripts/bench_b1.py:64-85)
DEFAULT_SIZES = {
    "yolov1": 448,
    "yolov2": 416,
    "yolov4": 416,
    "unet": 256,
    "unetp": 256,
    "unetpp": 256,
    "unet3p": 256,
    "unet_tvvgg11": 256,
    "unet_tvresnet34": 256,
    "unet_rexnet13": 256,
    "unet2": 256,
}


def bench_one(arch: str, size: int, iters: int, device) -> Dict:
    """One arch's row (``bench_b1.py:88-152``)."""
    device = torch.device(device)
    model = build_model(arch, device, torch.bfloat16, size)
    x = torch.randn(1, 3, size, size, generator=torch.Generator().manual_seed(SEED))
    x = x.to(device=device, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    fwd, _ = timed_forward(model, arch, x)
    summary = device_op_summary(fwd, x, iters=iters)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fwd(x)
    _sync(device)
    queued_ms = (time.perf_counter() - t0) / iters * 1e3
    ref_gpu, ref_cpu = REFERENCE_B1_MS.get(arch, (None, None))
    row = {
        "arch": arch,
        "batch": 1,
        "size": size,
        "dtype": "bfloat16",
        "form": "graph" if device.type == "cuda" else "eager",
        "device_ms": round(summary["ms_per_iter"], 4),
        "queued_ms": round(queued_ms, 3),
        "params_m": round(sum(p.numel() for p in model.parameters()) / 1e6, 2),
        "ref_gpu_ms": ref_gpu,
        "ref_cpu_ms": ref_cpu,
    }
    if ref_gpu and summary["ms_per_iter"] > 0:
        row["speedup_vs_ref_gpu"] = round(ref_gpu / summary["ms_per_iter"], 1)
    if row["form"] == "graph" and row["device_ms"] > 1.05 * row["queued_ms"]:
        row["device_ms_exceeds_queued"] = True
    row["device"] = device_label(device)
    return row


def main(args) -> List[Dict]:
    """The sweep (``bench_b1.py:154-167``); returns the rows it printed."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    rows = []
    for arch in args.archs or list(REFERENCE_B1_MS):
        try:
            row = bench_one(arch, args.size or DEFAULT_SIZES.get(arch, 224), args.it, device)
        except Exception as e:  # noqa: BLE001 — the sweep goes on past an arch that fails
            row = {"arch": arch, "error": f"{type(e).__name__}: {e}"}
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
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--archs", nargs="*", default=None, help="subset (default: every arch of the reference's table)")
    p.add_argument("--size", type=int, default=0,
                   help="0 = per-arch default (224; detection 416/448, segmentation 256)")
    p.add_argument("--it", type=int, default=100, help="iterations an arch (the reference's protocol: 100)")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    p.add_argument("--out", default=None, help="append JSONL rows here")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
