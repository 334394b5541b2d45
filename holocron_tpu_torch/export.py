#!/usr/bin/env python
"""Model export for serving, the port of ``scripts/export_model.py``:

    python -m holocron_tpu_torch.export repvgg_a0 --output repvgg_a0.pt2
    python -m holocron_tpu_torch.export yolov2 --size 416 --quantize --dtype bfloat16

``torch.export.export`` of the eval (deploy) module, after ``reparametrize()`` where
the model has it, written with ``torch.export.save`` (``--format pt2``), in place of the
JAX script's StableHLO. A detector's export holds its post-processing too
(``post_process`` with the module's ``rpn_nms_thresh`` and ``box_score_thresh``: the
score filter, the top 1,024 and the greedy NMS, whose loop unrolls into the graph) and
returns ``{boxes, scores, labels, keep}`` of fixed size (``export_model.py:53-63``).
``--quantize`` exports the selective-int8 form with per-call activation scales: its
graph holds the ``holocron_tpu_torch::int8_quantize`` and ``::int8_conv`` ops, which run
the card's kernels when the loaded program runs on the card. The file is loaded back
and its outputs compared with the eager module's (``export_model.py:75-80``): within
1e-5 in float32 (else it raises), and equal in bfloat16 and int8 (a difference there is
printed and returned, not hidden). ``--format savedmodel`` has no counterpart: TensorFlow is not a dependency of
the port, and ``torch.export``'s program is what it serves.
"""

import argparse
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .eval_latency import DETECTION, DTYPES, SEED, build_model

__all__ = ["OPS", "build_forward", "export", "main"]

OPS = ("holocron_tpu_torch.int8_quantize", "holocron_tpu_torch.int8_conv")


class _DetectionExport(nn.Module):
    """A detector's raw forward and its post-processing, as one program."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        from .models.detection import post_process

        boxes, b_o, b_scores = self.model.raw(x)
        return post_process(boxes.float(), b_o.float(), b_scores.float(), self.model.rpn_nms_thresh,
                            self.model.box_score_thresh)


def build_forward(arch: str, device, dtype: torch.dtype = torch.float32, size: int = 224, batch: int = 1,
                  num_classes: int = 10, quantize: bool = False):
    """``(module, example, num_params)`` (``export_model.py:20-67``): the module to export
    (a detector wrapped with its post-processing) and an example input."""
    model = build_model(arch, device, dtype, size, num_classes)
    num_params = sum(p.numel() for p in model.parameters())
    if quantize:
        from .quant import quantize_model

        with torch.no_grad():
            model = quantize_model(model, arch=arch).to(dtype)
    module = _DetectionExport(model) if arch in DETECTION else model
    example = torch.randn(batch, 3, size, size, generator=torch.Generator().manual_seed(SEED))
    example = example.to(device=device, dtype=dtype)
    if torch.device(device).type == "cuda":
        example = example.contiguous(memory_format=torch.channels_last)
    return module.eval(), example, num_params


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


def export(module: nn.Module, example: torch.Tensor, path: Path) -> Dict[str, Any]:
    """Exports ``module`` on ``example``, saves the program to ``path``, loads it back
    and compares its outputs with the eager module's; returns the export's seconds, the
    graph's node count, the custom ops it holds, the file's bytes and the largest
    difference (``max_abs_err``, and ``equal``: bit for bit)."""
    with torch.no_grad():
        t0 = time.perf_counter()
        program = torch.export.export(module, (example,))
        export_s = time.perf_counter() - t0
        torch.export.save(program, str(path))
        loaded = torch.export.load(str(path)).module()
        ref, got = _leaves(module(example)), _leaves(loaded(example))
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    diffs = [float((g.double() - r.double()).abs().max()) if r.numel() else 0.0 for g, r in zip(got, ref)]
    return {"export_s": export_s, "nodes": len(program.graph.nodes),
            "custom_ops": {op: sum(o.startswith(op) for o in ops) for op in OPS},
            "file_bytes": path.stat().st_size, "max_abs_err": max(diffs),
            "equal": all(torch.equal(g, r) for g, r in zip(got, ref)), "outputs": [tuple(r.shape) for r in ref]}


def main(args) -> Dict[str, Any]:
    """Exports ``args.arch`` and checks the round trip: raises where the loaded program's
    float32 outputs differ from the eager module's by more than 1e-5, and prints the
    difference where a bfloat16 or int8 one is not equal bit for bit."""
    if args.format != "pt2":
        raise ValueError(f"unsupported format: {args.format} (the port writes torch.export's .pt2 programs; a "
                         "TensorFlow SavedModel would need jax2tf and TensorFlow, which the port does not use)")
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    module, example, num_params = build_forward(args.arch, device, dtype, args.size, args.batch, args.num_classes,
                                                args.quantize)
    out_path = Path(args.output or f"{args.arch}.{args.format}")
    record = {"arch": args.arch, "dtype": args.dtype, "quantized": bool(args.quantize), "batch": args.batch,
              "size": args.size, **export(module, example, out_path)}
    if dtype == torch.float32 and not args.quantize and record["max_abs_err"] > 1e-5:
        raise AssertionError(f"the exported {args.arch} differs from the eager module: {record['max_abs_err']}")
    if not record["equal"]:
        print(f"The exported {args.arch} differs from the eager module by {record['max_abs_err']}")  # noqa: T201
    print(f"Exported {args.arch} ({num_params} params) to {out_path}: {record['nodes']} nodes in "  # noqa: T201
          f"{record['export_s']:.1f} s, {record['file_bytes']} bytes")
    return record


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Model export", formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("arch", type=str, help="architecture to export")
    parser.add_argument("--format", type=str, default="pt2", choices=["pt2", "savedmodel"])
    parser.add_argument("--output", type=str, default=None, help="output path")
    parser.add_argument("--size", type=int, default=224, help="input size")
    parser.add_argument("--batch", type=int, default=1, help="batch size")
    parser.add_argument("--num-classes", type=int, default=10, help="number of classes")
    parser.add_argument("--dtype", type=str, default="float32", choices=list(DTYPES))
    parser.add_argument("--quantize", action="store_true",
                        help="export the selective-int8 form (its graph holds the int8 ops)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
