"""The port's detection recipe and CLI against the JAX package's, on the CPU.

The box transforms take the same numpy inputs in both packages: boxes within 1e-6,
images equal where no resampling runs, PIL images equal where PIL resamples in both, and
float arrays within 1e-6 of their 255 range where each package's own bilinear resize
runs (``test_torch_segmentation_trainer.py``'s tolerance); uint8 images resized by the
two packages' resizes land within one level of 255 (a float rounding can cross a
truncation). ``RandomZoomOut`` draws the same scales from the same seed. ``main()`` runs
yolov2 at 64 px on synthetic data and on a folder of JPEGs and PNGs written here.
"""

import importlib.util
import json
import urllib.request
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from holocron_tpu.transforms.interpolation import RandomZoomOut as JaxRandomZoomOut
from holocron_tpu_torch.models.presets import IMAGENETTE
from holocron_tpu_torch.references.detection import train
from holocron_tpu_torch.references.detection import transforms as T
from holocron_tpu_torch.transforms import RandomZoomOut

torch.set_num_threads(2)

ROOT = Path(__file__).parent.parent
COMMON = ["--device", "cpu", "--img-size", "64", "--num-classes", "4", "--max-boxes", "8", "-b", "4"]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JT = _load("_jax_detection_transforms", ROOT / "references" / "detection" / "transforms.py")


def _sample(seed: int = 0, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    xy = np.sort(rng.random((3, 2, 2)) * np.asarray([shape[1], shape[0]]), axis=1)
    boxes = xy.transpose(0, 2, 1).reshape(3, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    return img, {"boxes": boxes, "labels": np.asarray([0, 2, 1], np.int64)}


def _same_target(ours, theirs) -> None:
    np.testing.assert_allclose(ours["boxes"], theirs["boxes"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours["labels"], theirs["labels"])


@pytest.mark.parametrize("kind", ["array", "float", "pil"])
def test_box_transforms_equal_jax(kind):
    """Resize, CenterCrop, both flips, convert_to_relative and Compose on the same
    image and boxes."""
    img, target = _sample()
    src = {"array": img, "float": img.astype(np.float32), "pil": Image.fromarray(img)}[kind]
    cases = [
        (T.Resize((40, 30)), JT.Resize((40, 30))),
        (T.CenterCrop((32, 40)), JT.CenterCrop((32, 40))),
        (T.RandomHorizontalFlip(p=1.0), JT.RandomHorizontalFlip(p=1.0)),
        (T.RandomHorizontalFlip(p=0.0), JT.RandomHorizontalFlip(p=0.0)),
        (T.Compose([T.Resize(36), T.RandomHorizontalFlip(p=1.0)]), JT.Compose([JT.Resize(36), JT.RandomHorizontalFlip(p=1.0)])),
        (T.ImageTransform(lambda im: im), JT.ImageTransform(lambda im: im)),
    ]
    for ours, theirs in cases:
        (o_img, o_t), (j_img, j_t) = ours(src, target), theirs(src, target)
        _same_target(o_t, j_t)
        o_arr, j_arr = np.asarray(o_img), np.asarray(j_img)
        assert o_arr.shape == j_arr.shape and o_arr.dtype == j_arr.dtype
        resampled = isinstance(ours, (T.Resize, T.Compose)) and kind != "pil"
        tol = 255e-6 if kind == "float" else 1
        if resampled:
            np.testing.assert_allclose(o_arr.astype(np.float32), j_arr.astype(np.float32), rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(o_arr, j_arr)
        _same_target(T.convert_to_relative(o_img, o_t)[1], JT.convert_to_relative(j_img, j_t)[1])


def test_flip_draws_from_the_given_generator():
    """A flip with ``rng`` draws from it (the CLI's per-sample generators); without one,
    from its own seeded generator, as the JAX flip does."""
    img, target = _sample()
    flip = T.RandomHorizontalFlip(p=0.5, seed=3)
    theirs = JT.RandomHorizontalFlip(p=0.5, seed=3)
    for _ in range(6):
        _same_target(flip(img, target)[1], theirs(img, target)[1])
    for seed in range(6):
        flipped = np.random.default_rng(seed).random() < 0.5
        out = flip(img, target, rng=np.random.default_rng(seed))[0]
        np.testing.assert_array_equal(out, img[:, ::-1] if flipped else img)


def test_voc_target_transform_equals_jax():
    ann = {"annotation": {"object": [
        {"name": "dog", "bndbox": {"xmin": "3", "ymin": "4", "xmax": "20", "ymax": "30"}},
        {"name": "cat", "bndbox": {"xmin": "1", "ymin": "2", "xmax": "5", "ymax": "9"}},
    ]}}
    classes = ["cat", "dog"]
    _same_target(T.VOCTargetTransform(classes)(None, ann)[1], JT.VOCTargetTransform(classes)(None, ann)[1])


@pytest.mark.parametrize("kind", ["float", "pil"])
def test_random_zoom_out_equals_jax(kind):
    """The same seed draws the same sizes; the shrunk and padded images agree (PIL
    exactly; float arrays within 1e-6 of 255); ``scale[0] == 1`` returns the image; the
    arguments are checked as in JAX."""
    img, _ = _sample(1, (50, 70))
    src = img.astype(np.float32) if kind == "float" else Image.fromarray(img)
    ours, theirs = RandomZoomOut((64, 64), scale=(0.3, 0.9), seed=5), JaxRandomZoomOut((64, 64), scale=(0.3, 0.9), seed=5)
    for _ in range(3):
        o, j = np.asarray(ours(src)), np.asarray(theirs(src))
        assert o.shape == j.shape == (64, 64, 3)
        if kind == "pil":
            np.testing.assert_array_equal(o, j)
        else:
            np.testing.assert_allclose(o, j, rtol=0, atol=255e-6)
    assert RandomZoomOut((64, 64), scale=(1.0, 1.0))(src) is src
    for bad in ({"size": (64,)}, {"size": (0, 64)}, {"size": (64, 64), "scale": (0.9, 0.3)}):
        kwargs = {"size": (64, 64), **bad}
        with pytest.raises(ValueError):
            RandomZoomOut(**kwargs)
        with pytest.raises(ValueError):
            JaxRandomZoomOut(**kwargs)


def _write_folder(root: Path, train_count: int = 6, val_count: int = 3) -> None:
    rng = np.random.default_rng(7)
    for split, count in (("train", train_count), ("val", val_count)):
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir(parents=True)
        for i in range(count):
            h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            if i % 2:
                img.save(root / split / "images" / f"{i}.png")
            else:
                img.save(root / split / "images" / f"{i}.jpg", quality=95)
            n = int(rng.integers(1, 4))
            xy = np.sort(rng.random((n, 2, 2)), axis=1).transpose(0, 2, 1).reshape(n, 4)[:, [0, 2, 1, 3]]
            labels = rng.integers(0, 4, n).tolist()
            (root / split / "labels" / f"{i}.json").write_text(json.dumps({"boxes": xy.tolist(), "labels": labels}))


def test_det_folder_equals_jax(tmp_path):
    """The module-level ``DetFolder`` against the JAX CLI's on its evaluation split: the
    same normalized images (within one uint8 level of the resize, over the preset's
    std) and the same relative boxes; the training split flips each sample by its own
    draw from ``(seed, epoch, index)``, the same in every process and epoch."""
    _write_folder(tmp_path)
    jax_cli = _load("_jax_detection_train", ROOT / "references" / "detection" / "train.py")
    args = Namespace(data_path=str(tmp_path), img_size=32, fake_samples=8, num_classes=4, batch_size=2, seed=0)
    _, jax_val = jax_cli.build_datasets(args)
    train_set, val_set = train.build_datasets(args)
    assert len(val_set) == len(jax_val) == 3 and len(train_set) == 6
    tol = 1 / 255 / min(IMAGENETTE.std) + 1e-6
    for i in range(len(val_set)):
        (x, t), (jx, jt) = val_set[i], jax_val[i]
        assert x.dtype == torch.float32 and tuple(x.shape) == (3, 32, 32)
        np.testing.assert_allclose(x.numpy().transpose(1, 2, 0), jx, rtol=0, atol=tol)
        _same_target(t, jt)
        assert t["boxes"].min() >= 0 and t["boxes"].max() <= 1
    again = train.build_datasets(args)[0]
    for i in range(len(train_set)):
        (x, t), (x2, t2) = train_set[i], again[i]
        assert torch.equal(x, x2)
        _same_target(t, t2)


def test_main_trains_tests_and_resumes(tmp_path, capsys):
    """``main()`` on ``fake`` (yolov2, 64 px, 4 classes, 8 boxes a target): an epoch that
    saves its checkpoint, ``--test-only --resume`` evaluating it, ``--check-setup`` and
    ``--find-lr``."""
    ckpt = tmp_path / "yolov2.pt"
    fake = ["fake", *COMMON, "--fake-samples", "8", "-j", "0", "--output-file", str(ckpt)]
    trainer = train.main(train.parse_args([*fake, "--epochs", "1"]))
    assert ckpt.exists() and trainer.step == 2 and trainer.model.max_boxes == 8
    out = capsys.readouterr().out
    assert "Loc error" in out and "saving state" in out
    resumed = train.main(train.parse_args([*fake, "--test-only", "--resume", str(ckpt)]))
    assert resumed.start_epoch == 1 and "Loc error" in capsys.readouterr().out
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, resumed.model.state_dict()[name]), name
    train.main(train.parse_args([*fake, "--check-setup"]))
    assert "overfit-one-batch losses" in capsys.readouterr().out
    lr = train.main(train.parse_args([*fake, "--find-lr"]))
    assert len(lr.lr_recorder) == len(lr.loss_recorder) == 2


def test_main_on_a_folder_with_spawned_workers(tmp_path):
    """A folder of JPEGs and PNGs through two spawned loader workers: the dataset and the
    collate are pickled into them, the padded training targets and the validation's
    lists of dicts reach the trainer."""
    _write_folder(tmp_path / "data", train_count=4, val_count=2)
    argv = [str(tmp_path / "data"), *COMMON, "-j", "2", "--epochs", "1", "--output-file", str(tmp_path / "d.pt")]
    trainer = train.main(train.parse_args(argv))
    assert trainer.step == 1 and (tmp_path / "d.pt").exists()


def test_main_refuses_what_the_port_does_not_run(monkeypatch, tmp_path):
    """Tensor and spatial parallelism are passed on, and one process cannot host a
    factor of 2 (``--shard-opt-state`` is accepted); ``--pretrained`` offline exits,
    as the JAX CLI does."""
    for flag in (["--model-parallel", "2"], ["--spatial-parallel", "2"]):
        with pytest.raises(ValueError, match="cannot host a (model|spatial)-parallel factor of 2"):
            train.main(train.parse_args(["fake", *COMMON, *flag]))
    trainer = train.main(train.parse_args(["fake", *COMMON, "-j", "0", "--fake-samples", "8", "--shard-opt-state", "--test-only"]))
    assert trainer.shard_opt_state and trainer.world_size == 1
    with pytest.raises(ValueError):
        train.build_optimizer(train.parse_args(["fake", "--opt", "sgd"]))
    monkeypatch.setenv("HOLOCRON_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: (_ for _ in ()).throw(OSError("offline")))
    with pytest.raises(SystemExit, match="--pretrained"):
        train.main(train.parse_args(["fake", *COMMON, "--fake-samples", "8", "-j", "0", "--pretrained"]))
