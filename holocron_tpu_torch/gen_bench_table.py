#!/usr/bin/env python
"""Renders :mod:`.bench_zoo` JSONL as a markdown table, the port of
``scripts/gen_bench_table.py``:

    python -m holocron_tpu_torch.gen_bench_table holocron_tpu_torch/models/_data/bench/zoo_h100_224_b128_bf16.jsonl \\
        --quant holocron_tpu_torch/models/_data/bench/zoo_h100_224_b128_int8.jsonl
    python -m holocron_tpu_torch.gen_bench_table b1.jsonl --b1

The column headers name the card the rows were measured on (their ``device`` field).
Original Holocron's README figures for its own GPU (:data:`REF_GPU_MS`) stand beside
them as the reference's numbers, not the port's. Needs no card.
"""

import argparse
import json
from typing import Dict, List, Optional

from .bench_b1 import REFERENCE_B1_MS

__all__ = ["REF_GPU_MS", "load", "main", "main_b1"]

# The reference's own GPU, from original Holocron's README: batch-1 mean latency in ms
# on an RTX 2070 Max-Q (with an i7-10750H), 224 px, reparametrized where the model can
# be (scripts/gen_bench_table.py:15-27).
REF_GPU_MS = {arch: gpu for arch, (gpu, _) in REFERENCE_B1_MS.items()}


def load(path: str) -> Dict[str, Dict]:
    """The rows of ``path`` by arch, error rows left out, the last row of an arch kept."""
    rows = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if "error" not in row:
                rows[row["arch"]] = row
    return rows


def _card(rows: Dict[str, Dict]) -> str:
    """The card the rows name (``device``), or the CPU's."""
    return next((r["device"].split(",")[0] for r in rows.values() if r.get("device")), "host")


def main_b1(args) -> List[str]:
    """A batch-1 table (rows with ``device_ms``) head to head with the reference's own
    batch-1 figures; returns the printed lines. A row whose kernel sum is above its
    queued time (``device_ms_exceeds_queued``) gets no speedup."""
    rows = load(args.jsonl)
    ordered = sorted(rows.values(), key=lambda r: r["device_ms"])
    lines = [f"| Arch | {_card(rows)} device ms (b=1) | reference GPU ms | reference CPU ms | vs GPU |",
             "|---|---|---|---|---|"]
    for r in ordered:
        gpu = f"{r['ref_gpu_ms']:.2f}" if r.get("ref_gpu_ms") else "—"
        cpu = f"{r['ref_cpu_ms']:.2f}" if r.get("ref_cpu_ms") else "—"
        speed = f"**{r['speedup_vs_ref_gpu']:.1f}x**" if r.get("speedup_vs_ref_gpu") else "—"
        if r.get("device_ms_exceeds_queued"):
            speed = f"— (device ms above queued {r['queued_ms']:.3f})"
        lines.append(f"| {r['arch']} | {r['device_ms']:.3f} | {gpu} | {cpu} | {speed} |")
    print("\n".join(lines))  # noqa: T201
    return lines


def main(args) -> List[str]:
    """The zoo table, fastest first, with the int8 rows' img/s where int8 is more than
    2% faster, and the reference's batch-1 GPU ms; returns the printed lines."""
    rows = load(args.jsonl)
    qrows = load(args.quant) if args.quant else {}
    ordered = sorted(rows.values(), key=lambda r: -r["img_per_sec"])
    card = _card(rows)
    cols = f"| Arch | params (M) | {card} ms / batch | {card} images/sec |"
    sep = "|---|---|---|---|"
    if qrows:
        cols += f" {card} int8 images/sec |"
        sep += "---|"
    cols += " reference GPU ms (b=1, RTX 2070 Max-Q) |"
    sep += "---|"
    lines = [cols, sep]
    for r in ordered:
        line = f"| {r['arch']} | {r['params_m']:.1f} | {r['mean_ms']:.2f} | {r['img_per_sec']:,.0f} |"
        if qrows:
            q = qrows.get(r["arch"])
            if q and q["img_per_sec"] > r["img_per_sec"] * 1.02:
                line += f" {q['img_per_sec']:,.0f} ({q['img_per_sec'] / r['img_per_sec']:.2f}x) |"
            else:
                line += " — |"
        ref = REF_GPU_MS.get(r["arch"])
        line += f" {ref:.2f} |" if ref else " — |"
        lines.append(line)
    print("\n".join(lines))  # noqa: T201
    return lines


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jsonl")
    p.add_argument("--quant", default=None, help="JSONL from bench_zoo --quantize")
    p.add_argument("--b1", action="store_true", help="render batch-1 JSONL (device_ms) head to head")
    return p.parse_args(argv)


if __name__ == "__main__":
    try:
        _args = parse_args()
        main_b1(_args) if _args.b1 else main(_args)
    except BrokenPipeError:  # `| head` is a normal way to use this
        pass
