#!/usr/bin/env python
"""Generates the port's int8 policy, ``models/_data/quant_policy.json``, from the card's
own zoo rows in ``models/_data/bench/`` (the port of ``scripts/gen_quant_policy.py``):

    python -m holocron_tpu_torch.gen_quant_policy

An arch's ``int8_speedup`` is its best int8 img/s over its best bf16 img/s
(:mod:`.bench_zoo` rows, batch 128 at 224 px for the classifiers, batch 32 for the
segmenters and detectors), and it is ``recommended`` at 1.05x or more
(``gen_quant_policy.py:85-108``). :data:`~holocron_tpu_torch.quant.INT8_VERDICTS` is read
from the file written here; rerun this after refreshing the rows. Needs no card.
"""

import json
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["BENCH", "BF16", "INT8", "MIN_IN_CHANNELS_OVERRIDES", "OUT", "QUALITY_GATE_VETOES",
           "STRIDE_POLICY_OVERRIDES", "best_per_arch", "main"]

DATA = Path(__file__).resolve().parent / "models" / "_data"
BENCH = DATA / "bench"
OUT = DATA / "quant_policy.json"

BF16 = ["zoo_h100_224_b128_bf16.jsonl", "zoo_h100_segdet_b32_bf16.jsonl"]
INT8 = ["zoo_h100_224_b128_int8.jsonl", "zoo_h100_segdet_b32_int8.jsonl"]


def best_per_arch(files: Iterable[str], bench: Optional[Path] = None) -> Dict[str, float]:
    """Each arch's best ``img_per_sec`` over the rows of ``files`` under ``bench``
    (default :data:`BENCH`; absent files and error rows skipped)."""
    best: Dict[str, float] = {}
    for name in files:
        path = (BENCH if bench is None else Path(bench)) / name
        if not path.exists():
            continue
        for line in path.read_text().splitlines():
            row = json.loads(line)
            if "img_per_sec" not in row:
                continue
            best[row["arch"]] = max(best.get(row["arch"], 0.0), row["img_per_sec"])
    return best


# The selection floor of the JAX package's policy, which quant.QUANT_POLICY copies: the
# selection stays the JAX package's, so that the same convs are int8 in both.
MIN_IN_CHANNELS_OVERRIDES = {
    "repvgg_a0": 48,
}

# Per-arch stride-2 handling (quantize_model's keywords of the same names), kept across
# regenerations; none is set, as in the JAX package.
STRIDE_POLICY_OVERRIDES: dict = {}

# Quality-gate vetoes: an arch whose int8 form fails its task's agreement gate against
# the reference form on trained weights stays un-recommended however fast int8 is. The
# port holds every task to 0.99: top-1 agreement, mean mask IoU, box-F1 (the JAX package
# vetoed yolov2 at 0.893 and passed yolov4 at 0.979-0.986). Each quotes the arch's
# longest-trained row of the card's own quant_accuracy
# (models/_data/bench/quant_accuracy*.jsonl, the gate's forms as the JAX script computes
# them), which decides: mobileone_s1 (0.8125 at 300 steps; 1.0 at 3000) and
# unet_rexnet13 (mask IoU 0.9531 at 300; 0.9994 at 1000) pass once trained longer;
# repvgg_b3 fails at 400 steps and at 1000. Speed rows alone would re-recommend a failed
# arch on the next regeneration.
_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
QUALITY_GATE_VETOES: dict = {
    "repvgg_b3": (
        "int8 top-1 agreement vs bf16 = 0.9844 (largest softmax drift 0.88713; accuracy 0.9922 / 0.9766) on "
        "trained weights (1000 steps, loss 0.002; 0.9883 at 400 steps); "
        f"quant_accuracy.jsonl, {_CARD}. Below 0.99."
    ),
    "yolov2": (
        "int8 box-F1 vs bf16 = 0.934 (precision 0.8761, recall 1.0, matched IoU 0.9247; 1.55 / 1.77 "
        "detections an image at objectness 0.25, score 0.01) on trained weights (2000 steps, loss 2.437); "
        f"quant_accuracy_segdet.jsonl, {_CARD}. Below 0.99."
    ),
    "yolov4": (
        "int8 box-F1 vs bf16 = 0.9596 (precision 0.9618, recall 0.9575, matched IoU 0.9901; 13.97 / 13.91 "
        "detections an image at objectness 0.5, score 0.05) on trained weights (1000 steps, loss 1.22; "
        f"0.9443 at 300 steps); quant_accuracy_segdet.jsonl, {_CARD}. Below 0.99."
    ),
}


def main(bench: Optional[Path] = None, out: Optional[Path] = None) -> Dict[str, Dict]:
    """Writes the policy of the rows under ``bench`` (default :data:`BENCH`) to ``out``
    (default :data:`OUT`) and returns it."""
    out = OUT if out is None else Path(out)
    bf16 = best_per_arch(BF16, bench)
    int8 = best_per_arch(INT8, bench)
    policy = {
        arch: {
            "int8_speedup": round(int8[arch] / bf16[arch], 3),
            "recommended": int8[arch] / bf16[arch] >= 1.05,
        }
        for arch in sorted(set(bf16) & set(int8))
    }
    for arch, floor in MIN_IN_CHANNELS_OVERRIDES.items():
        if arch in policy:
            policy[arch]["min_in_channels"] = floor
    for arch, overrides in STRIDE_POLICY_OVERRIDES.items():
        if arch in policy:
            policy[arch].update(overrides)
    for arch, reason in QUALITY_GATE_VETOES.items():
        if arch in policy:
            policy[arch]["recommended"] = False
            policy[arch]["quality_veto"] = reason
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(policy, indent=1) + "\n")
    n_rec = sum(1 for v in policy.values() if v["recommended"])
    print(f"wrote {out}: {len(policy)} archs, {n_rec} recommended for int8")  # noqa: T201
    return policy


if __name__ == "__main__":
    main()
