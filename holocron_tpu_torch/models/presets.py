"""Dataset presets: normalization statistics and class names
(``holocron_tpu/models/presets.py``).

The label data is the port's own copy of the JAX package's, in ``_data/presets.json``,
loaded once at import.
"""

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

__all__ = ["CIFAR10", "IMAGENET", "IMAGENETTE"]


@dataclass
class _Dataset:
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    classes: List[str]


def _load(name: str) -> _Dataset:
    data = json.loads((Path(__file__).parent / "_data" / "presets.json").read_text())[name]
    return _Dataset(mean=tuple(data["mean"]), std=tuple(data["std"]), classes=data["classes"])


IMAGENET = _load("IMAGENET")
IMAGENETTE = _load("IMAGENETTE")
CIFAR10 = _load("CIFAR10")
