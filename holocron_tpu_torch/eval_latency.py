#!/usr/bin/env python
"""Model latency and throughput, the port of ``scripts/eval_latency.py``:

    python -m holocron_tpu_torch.eval_latency repvgg_a0 --dtype bfloat16 --batch 32

The JAX protocol: random weights from a seed, ``reparametrize()`` where the model has
it, ``--warmup`` (10) calls, then ``--it`` (100) timed calls on one input; ``--quantize``
times the selective-int8 form, calibrated on that input, its float remainder in
``--dtype``. A call is the deploy forward captured once as a CUDA graph
(:func:`~holocron_tpu_torch.models.core.deploy_forward`: the input copied into the
graph's buffer, one replay), the port's counterpart of the JAX script's jitted forward
with the weights as constants. A detector is timed through its raw forward (no
post-processing), as the JAX script applies the module. Prints the device's mean ms a
call (CUDA events around the queued calls; host wall time on the CPU), one call's host
round trip (the call and a synchronize) and images a second. Runs on the card unless
``--device cpu``.
"""

import argparse
import time
from typing import Any, Dict, List, Optional, Union

import torch

from . import models
from .models.core import deploy_forward

__all__ = ["DETECTION", "build_model", "main", "timed_forward"]

DETECTION = ("yolov1", "yolov2", "yolov4")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEED = 0


def build_model(arch: str, device: Union[str, torch.device], dtype: torch.dtype = torch.float32,
                size: int = 224, num_classes: Optional[int] = None, seed: int = SEED) -> torch.nn.Module:
    """``arch`` in eval (deploy) form with random weights from ``seed``, reparametrized
    where it can be, in ``dtype``, channels_last on the card. A detector is built
    without its backbone's release (``pretrained_backbone=False``), yolov1's head for
    ``size``."""
    kwargs: Dict[str, Any] = {"device": device, "generator": torch.Generator().manual_seed(seed)}
    if num_classes is not None:
        kwargs["num_classes"] = num_classes
    if arch in DETECTION:
        kwargs["pretrained_backbone"] = False
        if arch == "yolov1":
            kwargs["input_shape"] = (3, size, size)
    model = models.__dict__[arch](**kwargs)
    if hasattr(model, "reparametrize"):
        model.reparametrize()
    model = model.eval().to(dtype)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def timed_forward(model: torch.nn.Module, arch: str, x: torch.Tensor, quantize: bool = False):
    """``(forward, seconds)``: the captured deploy forward of ``model`` (or of its int8
    form, calibrated on ``x``, its float remainder in ``x``'s dtype) at ``x``'s batch,
    and the seconds its quantization and capture took."""
    t0 = time.perf_counter()
    if quantize:
        from .quant import quantize_model

        with torch.no_grad():
            model = quantize_model(model, calibration_batches=[x], arch=arch).to(x.dtype)
    forward = model.raw if arch in DETECTION else None
    fwd = deploy_forward(model, [x.shape[0]], x.shape[-1], forward=forward)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return fwd, time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fwd, x: torch.Tensor, it: int, warmup: int) -> Dict[str, float]:
    """``warmup`` calls, one timed round trip, then ``it`` queued calls: the mean ms a
    call (CUDA events on the card), the round trip's ms and images a second."""
    for _ in range(warmup):
        fwd(x)
    _sync(x.device)
    t0 = time.perf_counter()
    fwd(x)
    _sync(x.device)
    rtt_ms = (time.perf_counter() - t0) * 1e3
    if x.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(it):
            fwd(x)
        end.record()
        end.synchronize()
        mean_ms = start.elapsed_time(end) / it
    else:
        t0 = time.perf_counter()
        for _ in range(it):
            fwd(x)
        mean_ms = (time.perf_counter() - t0) * 1e3 / it
    return {"mean_ms": mean_ms, "rtt_ms": rtt_ms, "img_per_s": x.shape[0] / (mean_ms / 1e3)}


def main(args) -> Dict[str, Any]:
    """Times ``args.arch`` and prints the JAX script's three lines; returns them as a
    record."""
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    model = build_model(args.arch, device, dtype, args.size)
    x = torch.randn(args.batch, 3, args.size, args.size, generator=torch.Generator().manual_seed(SEED))
    x = x.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)
    fwd, capture_s = timed_forward(model, args.arch, x, args.quantize)
    record = {"arch": args.arch, "device": str(device), "dtype": args.dtype, "batch": args.batch, "size": args.size,
              "quantized": bool(args.quantize), "capture_s": capture_s, **measure(fwd, x, args.it, args.warmup)}
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.arch} ({where}, {args.dtype}{', int8' if args.quantize else ''}, batch={args.batch}, "  # noqa: T201
          f"{args.size}px)")
    clock = "device" if device.type == "cuda" else "host"
    print(f"{clock} mean {record['mean_ms']:.3f}ms/iter, host round-trip {record['rtt_ms']:.3f}ms")  # noqa: T201
    print(f"throughput: {record['img_per_s']:.1f} images/sec")  # noqa: T201
    return record


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Model latency evaluation", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("arch", type=str, help="architecture to use")
    parser.add_argument("--size", type=int, default=224, help="input size")
    parser.add_argument("--batch", type=int, default=1, help="batch size")
    parser.add_argument("--it", type=int, default=100, help="number of timed iterations")
    parser.add_argument("--warmup", type=int, default=10, help="number of warmup iterations")
    parser.add_argument("--dtype", type=str, default="float32", choices=list(DTYPES))
    parser.add_argument("--quantize", action="store_true", help="selective int8 (holocron_tpu_torch.quant)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
