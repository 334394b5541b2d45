#!/usr/bin/env python
"""Semantic segmentation training CLI, the port of ``references/segmentation/train.py``.

    python -m holocron_tpu_torch.references.segmentation.train fake --arch unet3p

The same arguments and defaults, and ``--device`` (default ``cuda``; ``cpu`` runs on
the CPU). ``fake`` as ``data_path`` trains on synthetic data; a real dataset lies as
``<root>/{train,val}/images/*`` and ``<root>/{train,val}/masks/*`` (palette masks of
class indices, 255 ignored). One device: ``--model-parallel``, ``--spatial-parallel``
and ``--shard-opt-state`` are accepted at their defaults only.
"""

import argparse
import datetime
import time
from pathlib import Path
from typing import List, Optional

import numpy as np


def build_datasets(args):
    """The train and val datasets (``train.py:18-50``): synthetic, or the folder reader
    (images resized bilinearly and normalized, masks by half-pixel nearest)."""
    from holocron_tpu_torch.models.presets import IMAGENETTE
    from holocron_tpu_torch.transforms import Resize
    from holocron_tpu_torch.utils.data import SyntheticDataset, normalize_image

    if args.data_path == "fake":
        shape = (3, args.crop_size, args.crop_size)
        return (
            SyntheticDataset(args.fake_samples, shape, args.num_classes, task="segmentation"),
            SyntheticDataset(max(args.fake_samples // 4, args.batch_size), shape, args.num_classes,
                             task="segmentation", seed=1),
        )

    import torch
    from PIL import Image

    mean, std = IMAGENETTE.mean, IMAGENETTE.std
    resize = Resize((args.crop_size, args.crop_size))
    mask_resize = Resize((args.crop_size, args.crop_size), interpolation="nearest")

    class SegFolder:
        def __init__(self, root):
            self.images = sorted((Path(root) / "images").glob("*"))
            self.masks = {p.stem: p for p in (Path(root) / "masks").glob("*")}

        def __len__(self):
            return len(self.images)

        def __getitem__(self, idx):
            img = Image.open(self.images[idx]).convert("RGB")
            mask = Image.open(self.masks[self.images[idx].stem])
            img = normalize_image(resize(img), mean, std)
            mask = np.asarray(mask_resize(np.asarray(mask)[..., None]))[..., 0].astype(np.int64)
            return img, torch.from_numpy(mask)

    return SegFolder(Path(args.data_path) / "train"), SegFolder(Path(args.data_path) / "val")


def build_criterion(args, device):
    """The loss (``train.py:82-101``): cross-entropy or focal loss ignoring 255, or the
    soft Dice loss on the softmax; the background weighted by ``--bg-factor``. Logits
    are NCHW; the losses take them channel-last."""
    import torch

    from holocron_tpu_torch.nn import functional as F

    weight = None
    if args.bg_factor != 1:
        weight = torch.ones(args.num_classes, device=device)
        weight[0] = args.bg_factor
    if args.loss == "crossentropy":
        return lambda out, tgt: F.cross_entropy(out.permute(0, 2, 3, 1), tgt, weight=weight, ignore_index=255)
    if args.loss == "focal":
        return lambda out, tgt: F.focal_loss(out.permute(0, 2, 3, 1), tgt, weight=weight, ignore_index=255)
    if args.loss == "dice":
        def criterion(out, tgt):
            probs = torch.softmax(out, dim=1).permute(0, 2, 3, 1)
            onehot = torch.nn.functional.one_hot(tgt.clamp(0, args.num_classes - 1).long(), args.num_classes)
            return F.dice_loss(probs, onehot.to(probs.dtype), weight=weight)

        return criterion
    raise ValueError(f"unsupported loss: {args.loss}")


def build_optimizer(args):
    """``(param_groups, lr) -> optimizer`` for ``--opt`` (``train.py:103-113``): AdamW
    (decoupled decay), AdamP, RAdam (betas 0.95 / 0.99, eps 1e-6, decay added to the
    gradient) or AdaBelief, each with ``--wd``."""
    from holocron_tpu_torch import optim

    wd = args.weight_decay
    factories = {
        "adamw": lambda groups, lr: optim.AdamW(groups, lr, weight_decay=wd),
        "adamp": lambda groups, lr: optim.AdamP(groups, lr, weight_decay=wd),
        "radam": lambda groups, lr: optim.RAdam(groups, lr, betas=(0.95, 0.99), eps=1e-6, weight_decay=wd),
        "adabelief": lambda groups, lr: optim.AdaBelief(groups, lr, weight_decay=wd),
    }
    if args.opt not in factories:
        raise ValueError(f"unsupported optimizer: {args.opt}")
    return factories[args.opt]


def main(args):
    """Trains (or sweeps the learning rate, overfits a batch, evaluates) as
    ``train.py:53-158`` does; returns the trainer."""
    print(args)  # noqa: T201
    for flag, default in (("model_parallel", 1), ("spatial_parallel", 1), ("shard_opt_state", False)):
        if getattr(args, flag) != default:
            raise NotImplementedError(f"--{flag.replace('_', '-')}: the port trains on one device")

    import torch

    from holocron_tpu_torch.models import segmentation
    from holocron_tpu_torch.trainer import SegmentationTrainer

    device = torch.device(args.device)
    train_set, val_set = build_datasets(args)
    # spawned workers: the process may hold the card, which forked ones must not touch
    loader_kw = ({"num_workers": args.workers, "multiprocessing_context": "spawn", "persistent_workers": True}
                 if args.workers > 0 else {})
    train_loader = torch.utils.data.DataLoader(train_set, args.batch_size, shuffle=True, drop_last=True, **loader_kw)
    val_loader = torch.utils.data.DataLoader(val_set, args.batch_size, **loader_kw)

    model = segmentation.__dict__[args.arch](pretrained=args.pretrained, num_classes=args.num_classes, device=device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    trainer = SegmentationTrainer(
        model,
        train_loader,
        val_loader,
        build_criterion(args, device),
        build_optimizer(args),
        device=device,
        output_file=args.output_file,
        amp=args.amp,
        gradient_acc=args.grad_acc,
        num_classes=args.num_classes,
    )
    if args.resume:
        trainer.load(args.resume)
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
        import wandb

        run = wandb.init(name=args.name, project="holocron-tpu-segmentation", config=vars(args))
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
        description="holocron-tpu-torch segmentation training", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("data_path", type=str, help="dataset root ('fake' for synthetic data)")
    parser.add_argument("--arch", default="unet3p", type=str)
    parser.add_argument("--pretrained", action="store_true")
    parser.add_argument("--num-classes", default=21, type=int)
    parser.add_argument("--output-file", default="./checkpoint.ckpt")
    parser.add_argument("--resume", default="")
    parser.add_argument("--fake-samples", default=64, type=int)
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--device", default="cuda", type=str, help="where to train: cuda (the card) or cpu")
    parser.add_argument("--model-parallel", default=1, type=int, help="only 1: one device")
    parser.add_argument("--spatial-parallel", default=1, type=int, help="only 1: one device")
    parser.add_argument("--shard-opt-state", action="store_true", help="not supported: one device")
    parser.add_argument("-b", "--batch-size", default=16, type=int)
    parser.add_argument("-j", "--workers", default=8, type=int)
    parser.add_argument("--crop-size", default=256, type=int)
    parser.add_argument("--epochs", default=20, type=int)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--freeze-until", default=None, type=str)
    parser.add_argument("--grad-acc", default=1, type=int)
    parser.add_argument("--opt", default="adamp", type=str)
    parser.add_argument("--sched", default="onecycle", type=str)
    parser.add_argument("--wd", "--weight-decay", default=0, type=float, dest="weight_decay")
    parser.add_argument("--loss", default="crossentropy", type=str, choices=["crossentropy", "focal", "dice"])
    parser.add_argument("--bg-factor", default=1.0, type=float, help="background class weight")
    parser.add_argument("--norm-wd", default=None, type=float, help="weight decay of norm parameters")
    parser.add_argument("--find-lr", action="store_true")
    parser.add_argument("--check-setup", action="store_true")
    parser.add_argument("--test-only", action="store_true")
    parser.add_argument("--wb", action="store_true", help="log to Weights & Biases")
    parser.add_argument("--name", type=str, default=None)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
