#!/usr/bin/env python
"""Image classification training CLI, the port of ``references/classification/train.py``.

    python -m holocron_tpu_torch.references.classification.train fake --arch convnext_tiny

The same arguments and defaults, and ``--device`` (default ``cuda``; ``cpu`` runs on the
CPU). ``data_path`` is ``fake`` (synthetic data), an Imagenette-style folder
(``<root>/{train,val}/<class>/*``) or, with ``--dataset cifar10`` / ``cifar100``, the
root of an extracted CIFAR archive. A folder of JPEGs is decoded natively (decode,
RandomResizedCrop and flip in C++, uint8 batches normalized on the device) where the
native decoder builds, else with PIL, as the JAX CLI chooses. Batches come from
``torch.utils.data.DataLoader`` (``-j`` spawned worker processes); each image's recipe
draws from ``(--seed, epoch, index)``, Mixup's from ``(--seed, epoch, worker)``. One
device: ``--model-parallel``, ``--spatial-parallel`` and ``--shard-opt-state`` are
accepted at their defaults only.
"""

import argparse
import datetime
import time
import zlib
from functools import partial
from pathlib import Path
from typing import List, Optional

import numpy as np


def build_optimizer(args):
    """``(param_groups, lr) -> optimizer`` for ``--opt`` (``train.py:18-46``), each with
    ``--wd`` (a param group's own ``weight_decay``, ``--norm-wd``, replaces it): SGD
    (momentum 0.9) and Adam with the decay added to the gradient, AdamW (decoupled),
    RAdam (betas 0.95 / 0.99, eps 1e-6), LARS (momentum 0.9) and the port's AdamP,
    AdaBelief, AdEMAMix, LAMB, TAdam and Adan."""
    from holocron_tpu_torch import optim

    wd = args.weight_decay
    factories = {
        "sgd": lambda groups, lr: optim.SGD(groups, lr, momentum=0.9, weight_decay=wd),
        "adam": lambda groups, lr: optim.Adam(groups, lr, weight_decay=wd),
        "adamw": lambda groups, lr: optim.AdamW(groups, lr, weight_decay=wd),
        "radam": lambda groups, lr: optim.RAdam(groups, lr, betas=(0.95, 0.99), eps=1e-6, weight_decay=wd),
        "adamp": lambda groups, lr: optim.AdamP(groups, lr, weight_decay=wd),
        "adabelief": lambda groups, lr: optim.AdaBelief(groups, lr, weight_decay=wd),
        "ademamix": lambda groups, lr: optim.AdEMAMix(groups, lr, weight_decay=wd),
        "lamb": lambda groups, lr: optim.LAMB(groups, lr, weight_decay=wd),
        "lars": lambda groups, lr: optim.LARS(groups, lr, momentum=0.9, weight_decay=wd),
        "tadam": lambda groups, lr: optim.TAdam(groups, lr, weight_decay=wd),
        "adan": lambda groups, lr: optim.Adan(groups, lr, weight_decay=wd),
    }
    if args.opt not in factories:
        raise ValueError(f"unsupported optimizer: {args.opt}")
    return factories[args.opt]


class SeededRecipe:
    """A dataset whose samples go through the recipe's transforms with a generator of
    their own, ``np.random.default_rng([seed, epoch, index])``: the draws depend on
    neither the loader's workers nor their order, and change with the epoch
    (``set_epoch``, called by :class:`~holocron_tpu_torch.utils.data.EpochDataLoader`
    before the workers receive the dataset). ``transforms`` are ``(transform, random)``
    pairs; a random one is called with ``rng=``."""

    def __init__(self, dataset, transforms, seed: int) -> None:
        self.dataset, self.transforms, self.seed, self.epoch = dataset, transforms, seed, 0
        self.classes = getattr(dataset, "classes", None)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        img, target = self.dataset[idx]
        rng = np.random.default_rng([self.seed, self.epoch, idx])
        for tf, random in self.transforms:
            img = tf(img, rng=rng) if random else tf(img)
        return img, target


class NativeTrainCollate:
    """The native training batch (``train.py:91-139``): JPEG decode + RandomResizedCrop
    (scale 0.3-1) + flip in one native call, then TrivialAugmentWide and RandomErasing
    (on uint8, its fill drawn for the normalization applied later on the device) per
    image; uint8 out. Each batch's seeds come from ``(seed, epoch, crc32 of each
    buffer's first 4096 bytes and its length)``, as the JAX CLI draws them."""

    def __init__(self, crop: int, seed: int, random_erase: float, mean, std, num_threads: int) -> None:
        from holocron_tpu_torch.transforms import RandomErasing, TrivialAugmentWide

        self.crop, self.seed, self.random_erase, self.num_threads = crop, seed, random_erase, num_threads
        self.taw = TrivialAugmentWide()
        self.erase = RandomErasing(p=random_erase, scale=(0.02, 0.2), pixel_stats=(mean, std))
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __call__(self, batch: List):
        import torch

        from holocron_tpu_torch.utils.data import decode_rrc_batch

        buffers, ys = zip(*batch)
        n = len(buffers)
        entropy = [self.seed, self.epoch] + [zlib.crc32(bytes(b[:4096]), len(b)) for b in buffers]
        seeds = np.random.default_rng(np.random.SeedSequence(entropy)).integers(1, 2**63, size=2 * n, dtype=np.uint64)
        x_u8 = decode_rrc_batch(list(buffers), self.crop, self.crop, scale=(0.3, 1.0), seeds=seeds[:n],
                                num_threads=self.num_threads)
        out = []
        for img, img_seed in zip(x_u8, seeds[n:]):
            rng = np.random.default_rng(img_seed)
            img = self.taw(img, rng=rng)
            if self.random_erase > 0:
                img = self.erase(img, rng=rng)
            out.append(img)
        return torch.from_numpy(np.ascontiguousarray(np.stack(out))).permute(0, 3, 1, 2), torch.as_tensor(np.asarray(ys))


class MixupCollate:
    """``base`` then Mixup (``train.py:161-168``). Mixup draws from a generator made at
    the first batch of each epoch in each process, from ``(seed, epoch, worker)``: a
    worker receives a pickled copy of this collate, so a shared generator would repeat
    its draws in every worker and every epoch."""

    def __init__(self, base, num_classes: int, alpha: float, seed: int) -> None:
        self.base, self.num_classes, self.alpha, self.seed = base, num_classes, alpha, seed
        self.epoch, self._mix, self._key = 0, None, None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __call__(self, batch: List):
        import torch

        from holocron_tpu_torch.utils.data import Mixup

        info = torch.utils.data.get_worker_info()
        key = (self.epoch, -1 if info is None else info.id)
        if key != self._key:
            self._key = key
            self._mix = Mixup(self.num_classes, self.alpha, seed=[self.seed, self.epoch, key[1] + 1])
        return self._mix(*self.base(batch))


def _val_transform(img, resize, normalize, size: int) -> np.ndarray:
    """Resize, normalize, centre crop to ``size`` (``train.py:157-161``)."""
    arr = normalize(resize(img))
    off_h, off_w = (arr.shape[0] - size) // 2, (arr.shape[1] - size) // 2
    return arr[off_h : off_h + size, off_w : off_w + size]


def build_datasets(args):
    """``(train_set, val_set, classes, train_collate, val_collate, input_norm)``
    (``train.py:49-176``): synthetic data; an Imagenette-style folder, decoded natively
    (uint8 batches, ``input_norm`` the preset's mean and std) when every training file
    is a JPEG, ``--no-native`` is not set and the decoder builds, else the PIL recipe
    (RandomResizedCrop 0.3-1, flip, TrivialAugmentWide, normalization, RandomErasing
    0.02-0.2; evaluation: resize to ``--val-resize-size``, normalize, centre crop); or
    CIFAR-10/100 (flip, TrivialAugmentWide, normalization, RandomErasing)."""
    from holocron_tpu_torch.models.presets import CIFAR10 as CIFAR10_PRESET
    from holocron_tpu_torch.models.presets import IMAGENETTE
    from holocron_tpu_torch.transforms import (RandomErasing, RandomHorizontalFlip, RandomResizedCrop, Resize,
                                               TrivialAugmentWide)
    from holocron_tpu_torch.utils.data import (CIFAR10, CIFAR100, ImageFolder, NativeImageFolder, SyntheticDataset,
                                               native_available, native_collate, normalize_array)

    seed = args.seed
    if args.data_path == "fake":
        shape = (3, args.train_crop_size, args.train_crop_size)
        train_set = SyntheticDataset(args.fake_samples, shape, args.num_classes, seed=seed)
        val_set = SyntheticDataset(max(args.fake_samples // 4, args.batch_size), shape, args.num_classes, seed=seed + 1)
        return train_set, val_set, [str(i) for i in range(args.num_classes)], None, None, None

    dataset = args.dataset.lower()
    preset = IMAGENETTE if dataset == "imagenette" else CIFAR10_PRESET
    mean, std = preset.mean, preset.std
    normalize = partial(normalize_array, mean=mean, std=std)
    if dataset == "imagenette":
        train_dir, val_dir = Path(args.data_path) / "train", Path(args.data_path) / "val"
        folder = ImageFolder(train_dir)  # the directory scan decides the decode path
        all_jpeg = all(p.suffix.lower() in {".jpg", ".jpeg"} for p, _ in folder.samples)
        if all_jpeg and not args.no_native and native_available():
            train_collate = NativeTrainCollate(args.train_crop_size, seed, args.random_erase, mean, std, args.workers)
            val_collate = native_collate(args.val_resize_size, args.val_resize_size, mean, std,
                                         center_crop=args.val_crop_size, num_threads=args.workers)
            train_set = NativeImageFolder(train_dir)
            return train_set, NativeImageFolder(val_dir), train_set.classes, train_collate, val_collate, (mean, std)

        recipe = [
            (RandomResizedCrop(args.train_crop_size, scale=(0.3, 1.0)), True),
            (RandomHorizontalFlip(), True),
            (TrivialAugmentWide(), True),
            (normalize, False),
            (RandomErasing(p=args.random_erase, scale=(0.02, 0.2)), True),
        ]
        val_tf = partial(_val_transform, resize=Resize((args.val_resize_size, args.val_resize_size)),
                         normalize=normalize, size=args.val_crop_size)
        val_set = ImageFolder(val_dir, transform=val_tf)
        return SeededRecipe(folder, recipe, seed), val_set, folder.classes, None, None, None

    cifar = CIFAR100 if dataset == "cifar100" else CIFAR10
    recipe = [(RandomHorizontalFlip(), True), (TrivialAugmentWide(), True), (normalize, False),
              (RandomErasing(p=args.random_erase), True)]
    train_set = cifar(args.data_path, train=True)
    return (SeededRecipe(train_set, recipe, seed), cifar(args.data_path, train=False, transform=normalize),
            train_set.classes, None, None, None)


def build_criterion(args, num_classes: int):
    """Label-smoothed cross-entropy on dense targets (``train.py:246-250``): hard targets
    become one-hot, and smoothing applies to hard and soft (Mixup) targets alike."""
    import torch

    from holocron_tpu_torch.nn.functional import multilabel_cross_entropy

    def criterion(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if target.ndim != out.ndim:
            target = torch.nn.functional.one_hot(target.long(), num_classes).to(out.dtype)
        smoothed = target * (1 - args.label_smoothing) + args.label_smoothing / num_classes
        return multilabel_cross_entropy(out, smoothed)

    return criterion


def main(args):
    """Trains (or finds the image size or the learning rate, overfits a batch,
    evaluates) as ``train.py:179-307`` does; returns the trainer (None after
    ``--find-size``)."""
    print(args)  # noqa: T201
    for flag, default in (("model_parallel", 1), ("spatial_parallel", 1), ("shard_opt_state", False)):
        if getattr(args, flag) != default:
            raise NotImplementedError(f"--{flag.replace('_', '-')}: the port trains on one device")

    tracker = None
    if args.codecarbon:
        try:
            from codecarbon import EmissionsTracker
        except ImportError:
            print("codecarbon is not installed, skipping emission tracking")  # noqa: T201
        else:
            tracker = EmissionsTracker()
            tracker.start()

    import torch

    from holocron_tpu_torch.models import classification
    from holocron_tpu_torch.trainer import ClassificationTrainer
    from holocron_tpu_torch.utils.data import EpochDataLoader, default_collate

    device = torch.device(args.device)
    train_set, val_set, classes, train_collate, val_collate, input_norm = build_datasets(args)
    num_classes = args.num_classes or len(classes)
    collate = train_collate or default_collate
    if args.mixup_alpha > 0:
        collate = MixupCollate(collate, num_classes, args.mixup_alpha, args.seed)
    train_loader = EpochDataLoader(train_set, args.batch_size, shuffle=True, seed=args.seed, drop_last=True,
                                   collate_fn=collate, num_workers=args.workers)
    val_loader = EpochDataLoader(val_set, args.batch_size, collate_fn=val_collate or default_collate,
                                 num_workers=args.workers)
    print(f"Decoding with {'the native decoder' if train_collate is not None else 'PIL'}"  # noqa: T201
          if args.data_path != "fake" else "Synthetic data")

    model = classification.__dict__[args.arch](pretrained=args.pretrained, num_classes=num_classes, device=device,
                                               generator=torch.Generator().manual_seed(args.seed))
    if args.pretrained and not model.pretrained_loaded:
        raise SystemExit(
            "--pretrained was requested but the released weights could not be loaded "
            "(offline or invalid URL) — refusing to continue with random initialization"
        )
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    trainer = ClassificationTrainer(
        model,
        train_loader,
        val_loader,
        build_criterion(args, num_classes),
        build_optimizer(args),
        device=device,
        output_file=args.output_file,
        amp=args.amp,
        gradient_acc=args.grad_acc,
        gradient_clip=args.grad_clip,
        input_norm=input_norm,
    )
    if args.resume:
        print(f"Resuming {args.resume}")  # noqa: T201
        trainer.load(args.resume)

    if args.find_size:
        from holocron_tpu_torch.utils import find_image_size

        find_image_size(getattr(train_set, "dataset", train_set))
        return None
    if args.find_lr:
        trainer.find_lr(args.freeze_until, num_it=min(len(train_loader), 100), norm_weight_decay=args.norm_wd)
        for lr, loss in zip(trainer.lr_recorder, trainer.loss_recorder):
            print(f"lr={lr:.2e} loss={loss:.4f}")  # noqa: T201
        return trainer
    if args.check_setup:
        losses = trainer.check_setup(args.freeze_until, args.lr, norm_weight_decay=args.norm_wd, num_it=20)
        print(f"overfit-one-batch losses: {losses[0]:.4f} -> {losses[-1]:.4f}")  # noqa: T201
        return trainer
    if args.test_only:
        print(trainer._eval_metrics_str(trainer.evaluate()))  # noqa: T201
        return trainer

    run = None
    if args.wb:
        try:
            import wandb
        except ImportError:
            print("wandb is not installed, skipping experiment tracking")  # noqa: T201
        else:
            run = wandb.init(name=args.name, project="holocron-tpu-classification", config=vars(args))
            trainer.on_epoch_end = lambda metrics: run.log(metrics)

    print(f"Training {args.arch} for {args.epochs} epochs on {len(train_set)} samples")  # noqa: T201
    start_time = time.time()
    trainer.fit_n_epochs(args.epochs, args.lr, args.freeze_until, args.sched, norm_weight_decay=args.norm_wd)
    print(f"Training time {datetime.timedelta(seconds=int(time.time() - start_time))}")  # noqa: T201
    if run is not None:
        run.finish()
    if tracker is not None:
        tracker.stop()
    return trainer


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="holocron-tpu-torch classification training", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    group = parser.add_argument_group("Data & model")
    group.add_argument("data_path", type=str, help="path to dataset folder ('fake' for synthetic data)")
    group.add_argument("--dataset", default="imagenette", type=str,
                       help="dataset to train on (imagenette/cifar10/cifar100)")
    group.add_argument("--arch", default="darknet19", type=str, help="architecture to use")
    group.add_argument("--pretrained", action="store_true", help="use pre-trained parameters")
    group.add_argument("--num-classes", default=10, type=int, help="number of classes")
    group.add_argument("--output-file", default="./checkpoint.ckpt", help="path where to save")
    group.add_argument("--resume", default="", help="resume from checkpoint")
    group.add_argument("--fake-samples", default=64, type=int, help="synthetic dataset size")

    group = parser.add_argument_group("Hardware")
    group.add_argument("--amp", help="use bf16 mixed precision", action="store_true")
    group.add_argument("--device", default="cuda", type=str, help="where to train: cuda (the card) or cpu")
    group.add_argument("--model-parallel", default=1, type=int, help="only 1: one device")
    group.add_argument("--spatial-parallel", default=1, type=int, help="only 1: one device")
    group.add_argument("--shard-opt-state", action="store_true", help="not supported: one device")

    group = parser.add_argument_group("Data loading")
    group.add_argument("--seed", default=0, type=int,
                       help="pipeline seed (shuffle, native RRC/flip, augment tail, mixup, weights)")
    group.add_argument("-b", "--batch-size", default=32, type=int, help="batch size")
    group.add_argument("-j", "--workers", default=8, type=int, help="number of loader worker processes")
    group.add_argument("--no-native", action="store_true", help="disable the native (C++) JPEG decode fast path")

    group = parser.add_argument_group("Transformations")
    group.add_argument("--train-crop-size", default=176, type=int)
    group.add_argument("--val-resize-size", default=232, type=int)
    group.add_argument("--val-crop-size", default=224, type=int)
    group.add_argument("--mixup-alpha", default=0.2, type=float)
    group.add_argument("--random-erase", default=0.0, type=float, help="probability to do random erasing")

    group = parser.add_argument_group("Optimization")
    group.add_argument("--epochs", default=20, type=int)
    group.add_argument("--lr", default=1e-3, type=float)
    group.add_argument("--freeze-until", default=None, type=str)
    group.add_argument("--grad-acc", default=1, type=int)
    group.add_argument("--grad-clip", default=None, type=float)
    group.add_argument("--opt", default="adamp", type=str)
    group.add_argument("--sched", default="onecycle", type=str)
    group.add_argument("--wd", "--weight-decay", default=0, type=float, dest="weight_decay")
    group.add_argument("--norm-wd", default=None, type=float)
    group.add_argument("--label-smoothing", default=0.1, type=float)

    group = parser.add_argument_group("Actions")
    group.add_argument("--find-lr", action="store_true")
    group.add_argument("--find-size", dest="find_size", action="store_true", help="run the image size finder")
    group.add_argument("--check-setup", action="store_true")
    group.add_argument("--test-only", action="store_true")

    group = parser.add_argument_group("Experiment tracking")
    group.add_argument("--wb", action="store_true", help="log to Weights & Biases")
    group.add_argument("--codecarbon", action="store_true", help="track emissions with codecarbon")
    group.add_argument("--name", type=str, default=None)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
