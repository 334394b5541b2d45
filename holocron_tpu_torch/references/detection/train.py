#!/usr/bin/env python
"""Object detection training CLI, the port of ``references/detection/train.py``.

    python -m holocron_tpu_torch.references.detection.train fake --arch yolov2 --amp

The same arguments and defaults (yolov2, 20 classes, batch 8, 416 px, 50 boxes a
padded target, TAdam at 1e-4 under onecycle), ``--device`` (default ``cuda``; ``cpu``
runs on the CPU) and ``--seed``. ``data_path`` is ``fake`` (synthetic data) or a folder
``<root>/{train,val}/images/*`` with ``<root>/{train,val}/labels/<stem>.json`` holding
``{"boxes": [[xmin, ymin, xmax, ymax], ...] relative to the image, "labels": [...]}``:
images resized to ``--img-size`` with their boxes, flipped at random for training,
normalized on the host. Batches come from ``torch.utils.data.DataLoader`` (``-j``
spawned worker processes); each training image's flip draws from ``(--seed, epoch,
index)``.
Across processes (``torchrun``, one a device): the process group is joined from the
environment first (``parallel.initialize``), each process trains on ``cuda:LOCAL_RANK``
and on its own shard of both loaders (``num_shards="auto"``), W&B logs from rank 0, and
``--shard-opt-state`` shards the optimizer state (ZeRO-1), ``--model-parallel N`` splits
the model's channels over groups of N processes (tensor parallelism) and
``--spatial-parallel N`` the image rows (spatial partitioning), the batch over the rest.
"""

import argparse
import datetime
import json
import time
from functools import partial
from pathlib import Path
from typing import List, Optional

import numpy as np

from .transforms import Compose, RandomHorizontalFlip, Resize, convert_to_relative


class DetFolder:
    """A detection folder (``train.py:50-70``): ``<root>/images/*`` sorted by name, each
    with ``<root>/labels/<stem>.json``. A sample is the image through ``transform``
    (absolute boxes), its boxes made relative, the image normalized by the Imagenette
    preset into a float32 CHW tensor. ``transform`` draws from a generator of the
    sample's own, ``np.random.default_rng([seed, epoch, index])``: the draws depend
    neither on the loader's workers nor on their order, and change with the epoch
    (``set_epoch``, called by :class:`~holocron_tpu_torch.utils.data.EpochDataLoader`
    before the workers receive the dataset)."""

    def __init__(self, root, transform, seed: int = 0) -> None:
        self.images = sorted((Path(root) / "images").glob("*"))
        self.labels = {p.stem: p for p in (Path(root) / "labels").glob("*.json")}
        self.transform, self.seed, self.epoch = transform, seed, 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int):
        from PIL import Image

        from holocron_tpu_torch.models.presets import IMAGENETTE
        from holocron_tpu_torch.utils.data import normalize_image

        with Image.open(self.images[idx]) as im:
            img = np.asarray(im.convert("RGB"))
        meta = json.loads(self.labels[self.images[idx].stem].read_text())
        target = {
            # stored relative; the box transforms work in absolute pixels
            "boxes": np.asarray(meta["boxes"], np.float32).reshape(-1, 4)
            * np.asarray([img.shape[1], img.shape[0]] * 2, np.float32),
            "labels": np.asarray(meta["labels"], np.int64),
        }
        img, target = self.transform(img, target, rng=np.random.default_rng([self.seed, self.epoch, idx]))
        img, target = convert_to_relative(img, target)
        return normalize_image(img, IMAGENETTE.mean, IMAGENETTE.std), target


def train_collate(batch: List, max_boxes: int):
    """The training batch (``train.py:95-97``): images stacked, targets padded to
    ``max_boxes`` (:func:`~holocron_tpu_torch.models.detection.pad_targets`)."""
    from holocron_tpu_torch.models.detection import pad_targets
    from holocron_tpu_torch.utils.data import default_collate

    x, targets = default_collate(batch)
    return x, pad_targets(targets, max_boxes)


def build_datasets(args):
    """``(train_set, val_set)`` (``train.py:19-73``): synthetic detection samples, or the
    folder's splits (training: resize and a random flip; evaluation: resize)."""
    from holocron_tpu_torch.utils.data import SyntheticDataset

    if args.data_path == "fake":
        shape = (3, args.img_size, args.img_size)
        return (SyntheticDataset(args.fake_samples, shape, args.num_classes, task="detection"),
                SyntheticDataset(max(args.fake_samples // 4, args.batch_size), shape, args.num_classes,
                                 task="detection", seed=1))
    size = (args.img_size, args.img_size)
    root = Path(args.data_path)
    return (DetFolder(root / "train", Compose([Resize(size), RandomHorizontalFlip(p=0.5)]), args.seed),
            DetFolder(root / "val", Resize(size)))


def build_optimizer(args):
    """``(param_groups, lr) -> optimizer`` for ``--opt`` (``train.py:117-125``), each with
    ``--wd``: AdamW (decoupled), AdamP, TAdam, and RAdam (betas 0.95 / 0.99, eps 1e-6)
    after the decay added to the gradient, as ``add_decayed_weights`` chained before
    ``optax.radam``."""
    from holocron_tpu_torch import optim

    wd = args.weight_decay
    factories = {
        "adamw": lambda groups, lr: optim.AdamW(groups, lr, weight_decay=wd),
        "adamp": lambda groups, lr: optim.AdamP(groups, lr, weight_decay=wd),
        "tadam": lambda groups, lr: optim.TAdam(groups, lr, weight_decay=wd),
        "radam": lambda groups, lr: optim.RAdam(groups, lr, betas=(0.95, 0.99), eps=1e-6, weight_decay=wd),
    }
    if args.opt not in factories:
        raise ValueError(f"unsupported optimizer: {args.opt}")
    return factories[args.opt]


def main(args):
    """Trains (or finds the learning rate, overfits a batch, evaluates) as
    ``train.py:76-164`` does; returns the trainer."""
    print(args)  # noqa: T201

    import torch

    from holocron_tpu_torch.models import detection
    from holocron_tpu_torch.parallel import initialize, local_device, rank
    from holocron_tpu_torch.trainer import DetectionTrainer
    from holocron_tpu_torch.utils.data import EpochDataLoader, default_collate

    initialize(args.device)
    device = local_device(args.device)
    train_set, val_set = build_datasets(args)
    train_loader = EpochDataLoader(train_set, args.batch_size, shuffle=True, seed=args.seed, drop_last=True,
                                   collate_fn=partial(train_collate, max_boxes=args.max_boxes),
                                   num_workers=args.workers, num_shards="auto")
    val_loader = EpochDataLoader(val_set, args.batch_size, collate_fn=default_collate, num_workers=args.workers,
                                 num_shards="auto")

    kwargs = {"input_shape": (3, args.img_size, args.img_size)} if args.arch == "yolov1" else {}
    model = detection.__dict__[args.arch](pretrained=args.pretrained, pretrained_backbone=args.pretrained_backbone,
                                          num_classes=args.num_classes, device=device,
                                          generator=torch.Generator().manual_seed(args.seed), **kwargs)
    model.max_boxes = args.max_boxes
    if args.pretrained and not model.pretrained_loaded:
        raise SystemExit(
            "--pretrained was requested but the released weights could not be loaded "
            "(offline or invalid URL) — refusing to continue with random initialization"
        )
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    trainer = DetectionTrainer(
        model,
        train_loader,
        val_loader,
        None,
        build_optimizer(args),
        device=device,
        output_file=args.output_file,
        amp=args.amp,
        gradient_acc=args.grad_acc,
        gradient_clip=args.grad_clip,
        shard_opt_state=args.shard_opt_state,
        model_parallel=args.model_parallel,
        spatial_parallel=args.spatial_parallel,
    )
    if args.resume:
        print(f"Resuming {args.resume}")  # noqa: T201
        trainer.load(args.resume)
    if args.find_lr:
        trainer.find_lr(args.freeze_until, num_it=min(len(train_loader), 100), norm_weight_decay=args.norm_wd)
        for lr, loss in zip(trainer.lr_recorder, trainer.loss_recorder):
            print(f"lr={lr:.2e} loss={loss:.4f}")  # noqa: T201
        return trainer
    if args.check_setup:
        losses = trainer.check_setup(args.freeze_until, args.lr, norm_weight_decay=args.norm_wd, num_it=10)
        print(f"overfit-one-batch losses: {losses[0]:.4f} -> {losses[-1]:.4f}")  # noqa: T201
        return trainer
    if args.test_only:
        print(trainer._eval_metrics_str(trainer.evaluate()))  # noqa: T201
        return trainer

    run = None
    if args.wb and rank() == 0:
        import wandb

        run = wandb.init(name=args.name, project="holocron-tpu-detection", config=vars(args))
        trainer.on_epoch_end = lambda metrics: run.log(metrics)

    print(f"Training {args.arch} for {args.epochs} epochs")  # noqa: T201
    start_time = time.time()
    trainer.fit_n_epochs(args.epochs, args.lr, args.freeze_until, args.sched, norm_weight_decay=args.norm_wd)
    print(f"Training time {datetime.timedelta(seconds=int(time.time() - start_time))}")  # noqa: T201
    if run is not None:
        run.finish()
    return trainer


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="holocron-tpu-torch detection training", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("data_path", type=str, help="dataset root ('fake' for synthetic data)")
    parser.add_argument("--arch", default="yolov2", type=str)
    parser.add_argument("--pretrained", action="store_true")
    parser.add_argument("--pretrained-backbone", action="store_true")
    parser.add_argument("--num-classes", default=20, type=int)
    parser.add_argument("--output-file", default="./checkpoint.ckpt")
    parser.add_argument("--resume", default="")
    parser.add_argument("--fake-samples", default=32, type=int)
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--device", default="cuda", type=str, help="where to train: cuda (the card) or cpu")
    parser.add_argument("--model-parallel", default=1, type=int,
                        help="channel tensor-parallel factor (mesh 'model' axis); batch shards over the rest")
    parser.add_argument("--spatial-parallel", default=1, type=int,
                        help="spatial-partitioning factor (mesh 'spatial' axis): image height split, halos exchanged")
    parser.add_argument("--shard-opt-state", action="store_true",
                        help="ZeRO-1: each process keeps the optimizer state of its share of the parameters")
    parser.add_argument("--seed", default=0, type=int, help="the shuffle, the flips and the weights")
    parser.add_argument("-b", "--batch-size", default=8, type=int)
    parser.add_argument("-j", "--workers", default=8, type=int, help="number of loader worker processes")
    parser.add_argument("--img-size", default=416, type=int)
    parser.add_argument("--max-boxes", default=50, type=int, help="GT padding size (static shapes)")
    parser.add_argument("--epochs", default=40, type=int)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--freeze-until", default=None, type=str)
    parser.add_argument("--grad-acc", default=1, type=int)
    parser.add_argument("--grad-clip", default=None, type=float)
    parser.add_argument("--opt", default="tadam", type=str)
    parser.add_argument("--sched", default="onecycle", type=str)
    parser.add_argument("--wd", "--weight-decay", default=0, type=float, dest="weight_decay")
    parser.add_argument("--norm-wd", default=None, type=float, help="weight decay of norm parameters")
    parser.add_argument("--find-lr", action="store_true")
    parser.add_argument("--check-setup", action="store_true")
    parser.add_argument("--test-only", action="store_true")
    parser.add_argument("--wb", action="store_true", help="log to Weights & Biases")
    parser.add_argument("--name", type=str, default=None)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
