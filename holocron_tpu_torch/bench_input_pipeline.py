#!/usr/bin/env python
"""The host input pipeline's images a second, native decode against PIL, the port of
``scripts/bench_input_pipeline.py``:

    python -m holocron_tpu_torch.bench_input_pipeline --samples 512 --batch-size 64 --workers 8

It writes an Imagenette-shaped folder of random JPEGs (4 classes, 280-460 x 320-520 px,
quality 85; ``bench_input_pipeline.py:23-37``, the same bytes) into a temporary
directory and times the train and val pipelines the classification CLI builds for it
(:func:`loaders`): with PIL, RandomResizedCrop (scale 0.3-1), flip, TrivialAugmentWide,
normalization and RandomErasing, and for val a resize to 232, normalization and the
centre 224 crop; with the native decoder where it builds
(:func:`~.utils.data.native_available`), its fused decode, crop and flip, then
TrivialAugmentWide and RandomErasing on uint8 (the CLI normalizes on the card). Where it
does not build, PIL figures only. Each loader is timed over one
pass (:func:`bench_loader`: with workers, their start included). Runs on the host only:
no card is used.
"""

import argparse
import io
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["bench_loader", "loaders", "main", "synthesize_dataset"]

VAL_RESIZE, VAL_CROP = 232, 224


def synthesize_dataset(root: Path, num_samples: int, num_classes: int = 4) -> None:
    """``num_samples`` training and ``max(num_samples // 4, 16)`` validation JPEGs of
    uniform noise, a folder a class, drawn from ``numpy.random.default_rng(0)``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in (("train", num_samples), ("val", max(num_samples // 4, 16))):
        for cls in range(num_classes):
            d = root / split / f"class_{cls}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n // num_classes):
                h = int(rng.integers(280, 460))
                w = int(rng.integers(320, 520))
                arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG", quality=85)
                (d / f"img_{i}.jpg").write_bytes(buf.getvalue())


def bench_loader(loader) -> float:
    """Images a second over one pass of ``loader``. A loader that reads in this process
    gets a pass to warm up first (imports, allocator, page cache); one with workers does
    not: :class:`~.utils.data.EpochDataLoader` spawns its workers anew for each pass, so
    a warm-up pass would not warm them, and the timed pass counts their start, as the
    classification CLI pays it each epoch."""
    if loader.num_workers == 0:
        for _ in loader:
            pass
    n_imgs = 0
    start = time.perf_counter()
    for x, _ in loader:
        n_imgs += x.shape[0]
    return n_imgs / (time.perf_counter() - start)


def loaders(root: Path, args, native: bool) -> tuple:
    """The train and val loaders the classification CLI builds for the folder at
    ``root`` (:func:`~.references.classification.train.build_datasets`, the Imagenette
    recipe at ``--train-crop-size``, val resized to 232 and cropped to 224,
    RandomErasing at 0.5; natively decoded when ``native``, else with PIL), through
    :class:`~.utils.data.EpochDataLoader` with ``args.workers`` spawned workers."""
    from .references.classification.train import build_datasets
    from .utils.data import EpochDataLoader, default_collate

    cli = argparse.Namespace(data_path=str(root), dataset="imagenette", train_crop_size=args.train_crop_size,
                             val_resize_size=VAL_RESIZE, val_crop_size=VAL_CROP, random_erase=0.5,
                             no_native=not native, seed=0, workers=max(args.workers, 1))
    train_set, val_set, _, train_collate, val_collate, _ = build_datasets(cli)
    if native != (train_collate is not None):
        raise RuntimeError(f"asked for the {'native' if native else 'PIL'} decode, the CLI built the other")
    train = EpochDataLoader(train_set, args.batch_size, shuffle=True, drop_last=True, num_workers=args.workers,
                            collate_fn=train_collate or default_collate)
    val = EpochDataLoader(val_set, args.batch_size, num_workers=args.workers, collate_fn=val_collate or default_collate)
    return train, val


def main(args) -> Dict[str, float]:
    """Prints and returns images a second of each pipeline (and the native speedups)."""
    from .utils.data import native_available

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        print(f"synthesizing {args.samples} fake JPEGs...")  # noqa: T201
        synthesize_dataset(root, args.samples)
        pil_train, pil_val = loaders(root, args, native=False)
        results = {"pil_train_imgs_per_s": bench_loader(pil_train), "pil_val_imgs_per_s": bench_loader(pil_val)}
        if native_available():
            nat_train, nat_val = loaders(root, args, native=True)
            results["native_train_imgs_per_s"] = bench_loader(nat_train)
            results["native_val_imgs_per_s"] = bench_loader(nat_val)
            results["train_speedup"] = results["native_train_imgs_per_s"] / results["pil_train_imgs_per_s"]
            results["val_speedup"] = results["native_val_imgs_per_s"] / results["pil_val_imgs_per_s"]
        else:
            print("native loader unavailable; PIL numbers only")  # noqa: T201

    for k, v in results.items():
        print(f"{k}: {v:.1f}")  # noqa: T201
    return results


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--samples", default=512, type=int)
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--workers", default=8, type=int)
    p.add_argument("--train-crop-size", default=176, type=int)
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
