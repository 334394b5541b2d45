"""Datasets and batching of the reference CLIs (``holocron_tpu/utils/data/loader.py``),
for ``torch.utils.data.DataLoader``.

The JAX package's own threaded ``DataLoader`` is not copied: :class:`EpochDataLoader`
is torch's, with its behaviour kept (a seeded shuffle, and the collate's ``set_epoch``
hook called before each epoch).
"""

import itertools
from collections import deque
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["EpochDataLoader", "IMG_EXTENSIONS", "ImageFolder", "ShardSampler", "SyntheticDataset",
           "default_collate", "normalize_array", "normalize_image", "prefetch"]

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def prefetch(iterable: Iterable, fn: Optional[Callable] = None, size: int = 2) -> Iterator:
    """The items of ``iterable``, ``fn`` applied ``size`` items ahead of the consumer
    (``loader.py:21-42``). With ``fn`` an asynchronous copy to the device (the trainer's
    pinned, ``non_blocking`` placement), the next batches' copies run while the device
    computes the current one, as ``jax.device_put``'s do in the JAX loop."""
    it = iter(iterable)
    queue: deque = deque()

    def enqueue(n: int) -> None:
        for item in itertools.islice(it, n):
            queue.append(fn(item) if fn is not None else item)

    enqueue(max(size, 1))
    while queue:
        out = queue.popleft()
        enqueue(1)
        yield out


def normalize_array(img: Any, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """A uint8 HWC image (PIL or array) as a float32 HWC array, ``(x / 255 - mean) / std``
    (the JAX package's ``normalize_image``, ``loader.py:45-48``)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def normalize_image(img: Any, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """:func:`normalize_array` as a float32 CHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(normalize_array(img, mean, std).transpose(2, 0, 1)))


class ImageFolder:
    """A directory per class of images, read with PIL as RGB (the torchvision
    ``ImageFolder`` contract, ``loader.py:51-81``): classes sorted by name, each class's
    files sorted, the extensions of ``IMG_EXTENSIONS``."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None) -> None:
        self.root = Path(root)
        if not self.root.is_dir():
            raise FileNotFoundError(f"no such directory: {root}")
        self.classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[Path, int]] = [
            (p, self.class_to_idx[c])
            for c in self.classes
            for p in sorted((self.root / c).rglob("*"))
            if p.suffix.lower() in IMG_EXTENSIONS
        ]
        self.transform = transform
        self.target_transform = target_transform

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image

        path, target = self.samples[idx]
        with Image.open(path) as img:
            img = img.convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target


def default_collate(batch: List[Tuple[Any, Any]]) -> Tuple[torch.Tensor, Any]:
    """Stacks ``(image, target)`` samples into an NCHW batch and a target tensor
    (``loader.py:115-120``). CHW tensors are stacked as they are; HWC arrays (or PIL
    images) are stacked in numpy and returned as an NCHW view of the NHWC batch, in the
    channels-last memory format, without a copy. Dict targets (detection's) stay a list
    of dicts, as in the JAX package."""
    xs, ys = zip(*batch)
    if isinstance(xs[0], torch.Tensor):
        x = torch.stack(xs)
    else:
        x = torch.from_numpy(np.stack([np.asarray(v) for v in xs])).permute(0, 3, 1, 2)
    if isinstance(ys[0], dict):
        return x, list(ys)
    return x, torch.from_numpy(np.stack([np.asarray(v) for v in ys]))


class ShardSampler(torch.utils.data.Sampler):
    """One process's shard of each epoch's sample order (``loader.py:128-200``): the
    permutation the one-process loader draws (``RandomSampler`` over ``generator``; the
    identity without a shuffle), wrap-padded to a
    multiple of ``num_shards`` by repeating its head, then every ``num_shards``-th index
    from ``shard_index``. Every shard has ``ceil(n / num_shards)`` indices, so every
    process runs the same number of steps.

    ``num_shards="auto"``: the process group's size and this process's rank, until a
    trainer with a ``data`` axis narrower than the group (tensor or spatial parallelism)
    shards it over that axis (:meth:`shard_over`), so that the processes of a model or
    spatial group read the same rows."""

    def __init__(self, n: int, num_shards: Any, shard_index: int = 0, generator: Optional[torch.Generator] = None):
        self.auto = num_shards == "auto"
        if self.auto:
            from ...parallel.multihost import rank, world_size

            num_shards, shard_index = world_size(), rank()
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.n, self.num_shards, self.shard_index, self.generator = n, num_shards, shard_index, generator

    def shard_over(self, group) -> None:
        """Shards over the processes of ``group``: its size, this process's rank in it."""
        from torch import distributed as dist

        self.num_shards, self.shard_index = dist.get_world_size(group), dist.get_rank(group)

    def __len__(self) -> int:
        return -(-self.n // self.num_shards)

    def __iter__(self):
        if self.generator is not None:
            # RandomSampler's own draws, to the end of its iterator: the same generator
            # stream as the one-process loader's, epoch after epoch
            indices = list(torch.utils.data.RandomSampler(range(self.n), generator=self.generator))
        else:
            indices = list(range(self.n))
        total = len(self) * self.num_shards
        if indices:
            indices = (indices * -(-total // len(indices)))[:total]
        return iter(indices[self.shard_index :: self.num_shards])


class EpochDataLoader(torch.utils.data.DataLoader):
    """``torch.utils.data.DataLoader`` with the JAX loader's epoch hook
    (``loader.py:184-188``): before each epoch's iterator is made, the collate's and the
    dataset's ``set_epoch(epoch)`` are called, where they have one (0 for the first
    epoch). The shuffle is drawn from a generator seeded with ``seed``.

    ``num_shards`` / ``shard_index`` (``"auto"``: the process group's size and this
    process's rank, or the trainer's data axis, see :class:`ShardSampler`) give each
    process of a data-parallel job its :class:`ShardSampler` shard of the same
    permutation; one shard is the whole of it, the order torch's own shuffled or
    sequential sampler gives.

    With worker processes the collate and the dataset are pickled into them when the
    iterator is made, so the epoch reaches them only because it is set first and the
    workers are not kept across epochs (``persistent_workers`` is refused); workers are
    spawned, not forked (the process may hold the card).
    """

    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = False, seed: int = 0,
                 num_shards: Any = None, shard_index: Optional[int] = None, **kwargs: Any) -> None:
        if kwargs.get("persistent_workers"):
            raise ValueError("persistent workers would keep the first epoch's collate")
        if kwargs.get("num_workers", 0) > 0:
            kwargs.setdefault("multiprocessing_context", "spawn")
        if num_shards != "auto":
            num_shards = int(num_shards) if num_shards else 1
        generator = torch.Generator().manual_seed(seed) if shuffle else None
        sampler = ShardSampler(len(dataset), num_shards, int(shard_index or 0), generator)
        super().__init__(dataset, batch_size, sampler=sampler, generator=generator, **kwargs)
        self.epoch = -1

    @property
    def num_shards(self) -> int:
        return self.sampler.num_shards

    @property
    def shard_index(self) -> int:
        return self.sampler.shard_index

    def __iter__(self):
        self.epoch += 1
        for owner in (self.collate_fn, self.dataset):
            set_epoch = getattr(owner, "set_epoch", None)
            if set_epoch is not None:
                set_epoch(self.epoch)
        return super().__iter__()


class SyntheticDataset:
    """Random samples for smoke tests and ``--check-setup`` runs without data
    (``loader.py:84-112``): sample ``idx`` is drawn from ``np.random.default_rng(idx)``
    as the JAX package draws it (so both packages see the same samples; ``seed`` does
    not enter the draws there either), the image transposed to channel-first.

    Args:
        num_samples: the dataset's length
        shape: the image's ``(C, H, W)``
        num_classes: the classes the targets take
        task: ``classification`` (an int), ``segmentation`` (an ``(H, W)`` int64 mask)
            or ``detection`` (a dict of relative xyxy ``boxes`` and ``labels``)
    """

    def __init__(self, num_samples: int = 128, shape: Tuple[int, int, int] = (3, 224, 224), num_classes: int = 10,
                 task: str = "classification", seed: int = 0) -> None:
        if task not in ("classification", "segmentation", "detection"):
            raise ValueError(f"unknown task: {task}")
        self.num_samples, self.shape, self.num_classes, self.task, self.seed = (
            num_samples, tuple(shape), num_classes, task, seed)
        self._cache = {}

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        if idx not in self._cache:
            rng = np.random.default_rng(idx)
            c, h, w = self.shape
            img = torch.from_numpy(np.ascontiguousarray(rng.normal(size=(h, w, c)).astype(np.float32).transpose(2, 0, 1)))
            if self.task == "classification":
                tgt = int(rng.integers(0, self.num_classes))
            elif self.task == "segmentation":
                tgt = torch.from_numpy(rng.integers(0, self.num_classes, size=(h, w)).astype(np.int64))
            else:
                n = int(rng.integers(1, 4))
                boxes = np.sort(rng.random((n, 2, 2)), axis=1).transpose(0, 2, 1).reshape(n, 4).astype(np.float32)
                tgt = {"boxes": boxes[:, [0, 2, 1, 3]], "labels": rng.integers(0, self.num_classes, size=(n,))}
            self._cache[idx] = (img, tgt)
        return self._cache[idx]
