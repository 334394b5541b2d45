"""CIFAR-10/100 readers over the standard python-pickle archives, the port's copy of
``holocron_tpu/utils/data/cifar.py``.

The reference trains CIFAR through ``torchvision.datasets.CIFAR10/CIFAR100``
(reference references/classification/train.py:111-124, with ``download=True``). This
environment has no egress, so these readers consume an already-extracted archive
(``cifar-10-batches-py`` / ``cifar-100-python`` under ``root``) and raise a clear
error otherwise. Samples are ``(H, W, C) uint8`` numpy arrays (channel-last, this
package's layout) + int labels, matching the ImageFolder contract.
"""

import pickle
from pathlib import Path
from typing import Callable, Optional

import numpy as np

__all__ = ["CIFAR10", "CIFAR100"]


class CIFAR10:
    """CIFAR-10 from local pickle batches (torchvision file layout)."""

    base_folder = "cifar-10-batches-py"
    train_files = [f"data_batch_{i}" for i in range(1, 6)]
    test_files = ["test_batch"]
    meta_file = "batches.meta"
    labels_key = b"labels"
    names_key = b"label_names"

    def __init__(self, root: str, train: bool = True, transform: Optional[Callable] = None):
        base = Path(root) / self.base_folder
        if not base.is_dir():
            raise FileNotFoundError(
                f"no extracted CIFAR archive at {base} — download and extract it first "
                "(this environment cannot download datasets)"
            )
        data, labels = [], []
        for name in self.train_files if train else self.test_files:
            with open(base / name, "rb") as f:
                entry = pickle.load(f, encoding="bytes")
            data.append(entry[b"data"])
            labels.extend(entry.get(self.labels_key, entry.get(b"fine_labels")))
        # stored as (N, 3072) CHW rows -> channel-last HWC uint8
        self.data = np.vstack(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.targets = np.asarray(labels, dtype=np.int64)
        with open(base / self.meta_file, "rb") as f:
            meta = pickle.load(f, encoding="bytes")
        self.classes = [n.decode() for n in meta[self.names_key]]
        self.transform = transform

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int):
        img, target = self.data[idx], int(self.targets[idx])
        if self.transform is not None:
            img = self.transform(img)
        return img, target


class CIFAR100(CIFAR10):
    """CIFAR-100 (fine labels) from the local pickle archive."""

    base_folder = "cifar-100-python"
    train_files = ["train"]
    test_files = ["test"]
    meta_file = "meta"
    labels_key = b"fine_labels"
    names_key = b"fine_label_names"
