"""Miscellaneous utilities, the port's copy of ``holocron_tpu/utils/misc.py``: a
thread-pool map and the image-size finder of the classification CLI's ``--find-size``;
and the card's name and power limit that the benches write beside their numbers.
"""

import multiprocessing as mp
from math import sqrt
from multiprocessing.pool import ThreadPool
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

Inp = TypeVar("Inp")
Out = TypeVar("Out")

__all__ = ["device_label", "find_image_size", "parallel"]


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``), or
    ``cpu``."""
    import subprocess

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parallel(
    func: Callable[[Inp], Out],
    arr: Sequence[Inp],
    num_threads: Optional[int] = None,
    progress: bool = False,
    **kwargs: Any,
) -> Iterable[Out]:
    """ThreadPool map with an optional progress bar (reference misc.py:23-53)."""
    num_threads = num_threads if isinstance(num_threads, int) else min(16, mp.cpu_count())
    if progress:
        from tqdm.auto import tqdm
    if num_threads < 2:
        if progress:
            return list(map(func, tqdm(arr, total=len(arr), **kwargs)))
        return list(map(func, arr))
    with ThreadPool(num_threads) as tp:
        if progress:
            return list(tqdm(tp.imap(func, arr), total=len(arr), **kwargs))
        return tp.map(func, arr)


def find_image_size(dataset: Sequence[Tuple[Any, Any]], **kwargs: Any) -> Tuple[int, int]:
    """Median aspect-ratio/side histogram suggesting a target H x W
    (reference misc.py:55-90). Accepts PIL images, (H, W, C) arrays or (C, H, W)
    tensors; returns the suggestion as well as plotting it."""

    def get_size(sample):
        img = sample[0]
        if isinstance(img, torch.Tensor):  # CHW, the port's synthetic samples
            return img.shape[-1], img.shape[-2]
        if hasattr(img, "size") and not isinstance(img, np.ndarray):  # PIL
            return img.size  # (w, h)
        arr = np.asarray(img)
        return arr.shape[1], arr.shape[0]

    shapes_ = parallel(get_size, dataset, progress=True)
    shapes = np.asarray(shapes_)[:, ::-1]  # -> (h, w)
    ratios = shapes[:, 0] / shapes[:, 1]
    sides = np.sqrt(shapes[:, 0].astype(np.float64) * shapes[:, 1])

    median_ratio = np.median(ratios)
    median_side = np.median(sides)
    height = round(median_side * sqrt(median_ratio))
    width = round(median_side / sqrt(median_ratio))

    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2)
    axes[0].hist(ratios, bins=30, alpha=0.7)
    axes[0].title.set_text(f"Aspect ratio (median: {median_ratio:.2})")
    axes[0].grid(True, linestyle="--", axis="x")
    axes[0].axvline(median_ratio, color="r")
    axes[1].hist(sides, bins=30, alpha=0.7)
    axes[1].title.set_text(f"Side (median: {int(median_side)})")
    axes[1].grid(True, linestyle="--", axis="x")
    axes[1].axvline(median_side, color="r")
    fig.suptitle(f"Median image size: ({height}, {width})")
    plt.show(**kwargs)
    return height, width
