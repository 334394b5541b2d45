"""The port's classification recipe and CLI against the JAX package's, on the CPU.

The host-side recipe (RandomResizedCrop, RandomHorizontalFlip, TrivialAugmentWide,
RandomErasing, Mixup) draws from numpy Generators in the same order in both packages,
so the same seed gives the same images bit for bit; the native decode is the same
library through both bindings; the criterion is held within 1e-6; ``main()`` runs on
the CPU on synthetic data and on a folder of JPEGs and PNGs written here."""

import importlib.util
import pickle
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from holocron_tpu import transforms as jax_tf
from holocron_tpu.nn import functional as jax_F
from holocron_tpu.utils import data as jax_data
from holocron_tpu_torch import transforms, utils
from holocron_tpu_torch.references.classification import train
from holocron_tpu_torch.utils import data

torch.set_num_threads(2)

ROOT = Path(__file__).parent.parent
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """No network: fetching a release URL fails as it does offline, into an empty cache."""
    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setenv("HOLOCRON_CACHE_DIR", str(tmp_path))


def _jax_cli():
    spec = importlib.util.spec_from_file_location("_jax_classification_train",
                                                  ROOT / "references" / "classification" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(seed: int = 0, count: int = 4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(rng.integers(40, 70)), int(rng.integers(40, 70)), 3), dtype=np.uint8)
            for _ in range(count)]


def _same(ours, theirs) -> None:
    if isinstance(theirs, Image.Image):
        assert isinstance(ours, Image.Image) and ours.mode == theirs.mode
        ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("kind", ["pil", "array"])
def test_crop_and_flip_equal_jax(kind):
    """RandomResizedCrop and RandomHorizontalFlip on the same seed: the same crops
    (parameters, and pixels for PIL images, which both packages resize with PIL) and
    the same flips. Arrays are resized by each package's own resize (``jax.image`` and
    ``F.interpolate``): within 1 of the uint8 range there."""
    for i, img in enumerate(_images()):
        src = Image.fromarray(img) if kind == "pil" else img
        ours, theirs = transforms.RandomResizedCrop(24, scale=(0.3, 1.0)), jax_tf.RandomResizedCrop(24, scale=(0.3, 1.0))
        r1, r2 = np.random.default_rng(i), np.random.default_rng(i)
        assert ours.get_params(src, r1) == theirs.get_params(src, r2)
        out_o, out_t = ours(src, np.random.default_rng(i)), theirs(src, np.random.default_rng(i))
        if kind == "pil":
            _same(out_o, out_t)
        else:
            np.testing.assert_allclose(out_o.astype(np.int32), out_t.astype(np.int32), rtol=0, atol=1)
        flip_o, flip_t = transforms.RandomHorizontalFlip(), jax_tf.RandomHorizontalFlip()
        for _ in range(4):
            _same(flip_o(src, r1), flip_t(src, r2))


TAW_OPS = jax_tf.TrivialAugmentWide()._ops


@pytest.mark.parametrize("op", TAW_OPS)
def test_trivial_augment_every_op_equals_jax(op):
    """Each of the 14 ops forced (the op list cut to it; the op draw still consumes the
    generator), on PIL images and arrays, several magnitudes and signs each."""
    for i, img in enumerate(_images(1)):
        ours, theirs = transforms.TrivialAugmentWide(), jax_tf.TrivialAugmentWide()
        ours._ops, theirs._ops = [op], [op]
        r1, r2 = np.random.default_rng(i), np.random.default_rng(i)
        for src in (img, Image.fromarray(img)):
            _same(ours(src, r1), theirs(src, r2))


def test_random_erasing_equals_jax_on_floats_and_uint8():
    """p = 1: float (after normalization) and uint8 with ``pixel_stats`` (the fill drawn
    for the normalization applied later)."""
    for i, img in enumerate(_images(2)):
        for src, kwargs in ((data.normalize_array(img, MEAN, STD), {}), (img, {"pixel_stats": (MEAN, STD)})):
            ours = transforms.RandomErasing(p=1.0, scale=(0.02, 0.2), **kwargs)
            theirs = jax_tf.RandomErasing(p=1.0, scale=(0.02, 0.2), **kwargs)
            out = ours(src, np.random.default_rng(i))
            _same(out, theirs(src, np.random.default_rng(i)))
            assert not np.array_equal(out, src)
    with pytest.raises(ValueError, match="pixel_stats"):
        transforms.RandomErasing(p=1.0)(_images(3, 1)[0], np.random.default_rng(0))


def test_compose_and_normalize_equal_jax():
    img = _images(4, 1)[0]
    np.testing.assert_array_equal(data.normalize_array(img, MEAN, STD), jax_data.normalize_image(img, MEAN, STD))
    ours = transforms.Compose([transforms.RandomHorizontalFlip(seed=3), transforms.TrivialAugmentWide(seed=4)])
    theirs = jax_tf.Compose([jax_tf.RandomHorizontalFlip(seed=3), jax_tf.TrivialAugmentWide(seed=4)])
    for _ in range(3):
        _same(ours(img), theirs(img))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_mixup_equals_jax(dtype):
    """uint8 (mixed in float32, ``rint`` back) and float batches, numpy in and out; a CPU
    tensor batch gives the same values as a tensor."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (6, 8, 8, 3)).astype(dtype)
    y = rng.integers(0, 4, 6)
    ours, theirs = data.Mixup(4, alpha=0.4, seed=7), jax_data.Mixup(4, alpha=0.4, seed=7)
    for _ in range(3):
        (xo, yo), (xt, yt) = ours(x, y), theirs(x, y)
        _same(xo, xt)
        _same(yo, yt)
    xo, yo = data.Mixup(4, alpha=0.4, seed=7)(torch.from_numpy(x), torch.from_numpy(y))
    xt, yt = jax_data.Mixup(4, alpha=0.4, seed=7)(x, y)
    _same(xo.numpy(), xt)
    _same(yo.numpy(), yt)


def _jpegs(tmp_path: Path, count: int = 5):
    paths = []
    for i, img in enumerate(_images(6, count)):
        path = tmp_path / f"{i}.jpg"
        Image.fromarray(img).save(path, quality=90)
        paths.append(path)
    return [p.read_bytes() for p in paths]


def test_native_decode_equals_the_jax_binding(tmp_path):
    """decode_rrc_batch (the same seeds), decode_batch and native_collate's centre crop
    through the port's binding and the JAX package's, on the same library source."""
    if not data.native_available() or not jax_data.native_available():
        pytest.skip("the native decoder cannot be built here (no g++ or libjpeg)")
    buffers = _jpegs(tmp_path)
    seeds = np.random.default_rng(8).integers(1, 2**63, size=len(buffers), dtype=np.uint64)
    ours = data.decode_rrc_batch(buffers, 24, 24, scale=(0.3, 1.0), seeds=seeds, num_threads=2)
    _same(ours, jax_data.decode_rrc_batch(buffers, 24, 24, scale=(0.3, 1.0), seeds=seeds, num_threads=2))
    _same(data.decode_batch(buffers, 30, 30, MEAN, STD, 2), jax_data.decode_batch(buffers, 30, 30, MEAN, STD, 2))
    batch = [(b, i % 3) for i, b in enumerate(buffers)]
    x, y = data.native_collate(30, 30, MEAN, STD, center_crop=24, num_threads=2)(batch)
    xt, yt = jax_data.native_collate(30, 30, MEAN, STD, center_crop=24, num_threads=2)(batch)
    assert x.shape == (5, 3, 24, 24)
    _same(x.permute(0, 2, 3, 1).numpy(), xt)
    _same(y.numpy(), yt)


def test_native_training_batch_equals_the_jax_cli(monkeypatch, tmp_path):
    """The native branch's training batch (decode + crop + flip, TrivialAugmentWide and
    uint8 RandomErasing, seeds from the buffers, the seed and the epoch) equals the JAX
    CLI's on the same buffers, in two epochs."""
    if not data.native_available() or not jax_data.native_available():
        pytest.skip("the native decoder cannot be built here (no g++ or libjpeg)")
    root = tmp_path / "data"
    _write_folder(root)
    for path in root.rglob("*.png"):
        path.unlink()
    argv = [str(root), "--train-crop-size", "32", "--random-erase", "0.5", "-j", "2", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    theirs = _jax_cli().build_datasets(_jax_cli().parse_args())
    ours = train.build_datasets(train.parse_args(argv))
    assert ours[5] == theirs[5] and ours[2] == theirs[2]
    batch = [ours[0][i] for i in range(6)]
    for epoch in (0, 1):
        theirs[3].set_epoch(epoch)
        ours[3].set_epoch(epoch)
        (x, y), (xt, yt) = ours[3](batch), theirs[3](batch)
        assert x.dtype == torch.uint8 and x.shape == (6, 3, 32, 32)
        _same(x.permute(0, 2, 3, 1).numpy(), xt)
        _same(y.numpy(), yt)


@pytest.mark.parametrize("cls,folder,files,labels_key,names_key", [
    ("CIFAR10", "cifar-10-batches-py", ([f"data_batch_{i}" for i in range(1, 6)], ["test_batch"], "batches.meta"),
     b"labels", b"label_names"),
    ("CIFAR100", "cifar-100-python", (["train"], ["test"], "meta"), b"fine_labels", b"fine_label_names"),
])
def test_cifar_reads_a_pickled_archive(tmp_path, cls, folder, files, labels_key, names_key):
    """The python-pickle batches written here: channel-last uint8 images equal to the
    JAX reader's, labels, class names, a transform applied, a missing archive refused."""
    train_files, test_files, meta = files
    base = tmp_path / folder
    base.mkdir()
    rng = np.random.default_rng(9)
    for name in train_files + test_files:
        entry = {b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8), labels_key: [0, 1, 2]}
        (base / name).write_bytes(pickle.dumps(entry))
    (base / meta).write_bytes(pickle.dumps({names_key: [b"a", b"b", b"c"]}))
    ours, theirs = getattr(data, cls)(str(tmp_path)), getattr(jax_data, cls)(str(tmp_path))
    assert len(ours) == 3 * len(train_files) and ours.classes == ["a", "b", "c"]
    for i in range(len(ours)):
        (a, ya), (b, yb) = ours[i], theirs[i]
        _same(a, b)
        assert a.shape == (32, 32, 3) and ya == yb
    test = getattr(data, cls)(str(tmp_path), train=False, transform=lambda img: img[:2])
    assert len(test) == 3 and test[0][0].shape == (2, 32, 3)
    with pytest.raises(FileNotFoundError):
        getattr(data, cls)(str(tmp_path / "missing"))


def test_batch_preprocessing_matches_jax():
    """space_to_depth_batch exactly; fused_preprocess (uint8 -> resized, normalized) within
    1e-5 of ``jax.image.resize``'s, returned NCHW in channels-last memory."""
    rng = np.random.default_rng(10)
    x = rng.integers(0, 256, (2, 20, 24, 3), dtype=np.uint8)
    _same(transforms.space_to_depth_batch(x), jax_tf.functional.space_to_depth_batch(x))
    for size in ((10, 12), (28, 30)):
        ours = transforms.fused_preprocess(torch.from_numpy(x), size, dtype=torch.float32)
        theirs = np.asarray(jax_tf.fused_preprocess(jnp.asarray(x), size, dtype=jnp.float32))
        assert ours.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), theirs, rtol=0, atol=1e-5)


def test_find_image_size_matches_jax(monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    images = [(img, 0) for img in _images(11, 6)]
    assert utils.find_image_size(images) == jax_data_misc().find_image_size(images)
    assert utils.parallel(lambda v: v * 2, [1, 2, 3], num_threads=2) == [2, 4, 6]


def jax_data_misc():
    from holocron_tpu.utils import misc

    return misc


def test_parse_args_defaults_equal_the_jax_cli(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train.py", "fake"])
    theirs = vars(_jax_cli().parse_args())
    ours = vars(train.parse_args(["fake"]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert (ours["arch"], ours["opt"], ours["sched"], ours["batch_size"]) == ("darknet19", "adamp", "onecycle", 32)
    assert (ours["train_crop_size"], ours["val_resize_size"], ours["val_crop_size"]) == (176, 232, 224)
    assert (ours["mixup_alpha"], ours["label_smoothing"]) == (0.2, 0.1)


@pytest.mark.parametrize("soft", [False, True])
def test_criterion_matches_jax(soft):
    """Label smoothing on hard targets (one-hot first) and on soft ones, the JAX CLI's
    expression (``train.py:246-250``) within 1e-6."""
    rng = np.random.default_rng(12)
    out = rng.normal(size=(6, 5)).astype(np.float32) * 3
    target = rng.dirichlet(np.ones(5), 6).astype(np.float32) if soft else rng.integers(0, 5, 6)
    args = train.parse_args(["fake"])
    ours = float(train.build_criterion(args, 5)(torch.from_numpy(out), torch.from_numpy(target)))
    jt = jnp.asarray(target) if soft else jax.nn.one_hot(jnp.asarray(target), 5, dtype=jnp.float32)
    theirs = float(jax_F.multilabel_cross_entropy(jnp.asarray(out), jt * (1 - 0.1) + 0.1 / 5))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


def test_optimizer_choices_cover_the_jax_cli():
    args = train.parse_args(["fake", "--wd", "1e-2"])
    params = [torch.nn.Parameter(torch.ones(3))]
    for opt in ("sgd", "adam", "adamw", "radam", "adamp", "adabelief", "ademamix", "lamb", "lars", "tadam", "adan"):
        args.opt = opt
        optimizer = train.build_optimizer(args)([{"params": params}], 1e-3)
        assert optimizer.param_groups[0]["weight_decay"] == 1e-2
    args.opt = "nope"
    with pytest.raises(ValueError):
        train.build_optimizer(args)


def _write_folder(root: Path) -> None:
    rng = np.random.default_rng(13)
    for split in ("train", "val"):
        for c in range(3):
            folder = root / split / f"class{c}"
            folder.mkdir(parents=True)
            for i in range(4):
                img = Image.fromarray(rng.integers(0, 256, (int(rng.integers(36, 50)), 44, 3), dtype=np.uint8))
                img.save(folder / (f"{i}.png" if i == 0 and c == 0 else f"{i}.jpg"))


COMMON = ["--device", "cpu", "-b", "4", "-j", "0", "--num-classes", "3", "--train-crop-size", "32",
          "--val-resize-size", "40", "--val-crop-size", "32"]


def _steps(monkeypatch):
    steps = []
    step = train_trainer().ClassificationTrainer._run_step_async

    def counted(self, x, target):
        steps.append((tuple(x.shape), x.dtype, tuple(target.shape)))
        return step(self, x, target)

    monkeypatch.setattr(train_trainer().ClassificationTrainer, "_run_step_async", counted)
    return steps


def train_trainer():
    from holocron_tpu_torch import trainer

    return trainer


def test_main_trains_on_fake_data_then_resumes(monkeypatch, tmp_path, capsys):
    """Two steps of mobileone_s0 with LARS on ``fake`` (Mixup's soft targets), a
    checkpoint, then ``--test-only --resume`` reading it back."""
    steps = _steps(monkeypatch)
    ckpt = tmp_path / "fake.pt"
    trainer = train.main(train.parse_args(["fake", "--arch", "mobileone_s0", "--opt", "lars", "--fake-samples", "8",
                                           "--epochs", "1", "--output-file", str(ckpt), *COMMON]))
    assert steps == [((4, 3, 32, 32), torch.float32, (4, 3))] * 2
    assert trainer._opt.param_groups[0]["count"] == 2 and ckpt.exists()
    resumed = train.main(train.parse_args(["fake", "--arch", "mobileone_s0", "--test-only", "--resume", str(ckpt),
                                           "--fake-samples", "8", *COMMON]))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert "Validation loss" in capsys.readouterr().out


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_main_trains_on_an_image_folder(monkeypatch, tmp_path, capsys, native):
    """convnext_atto at 32 px on a folder of JPEGs (and, for PIL, one PNG): the native
    branch where every file is a JPEG and the decoder builds (uint8 batches normalized
    on the device), the PIL recipe otherwise; an epoch (11 or 12 images: 2 or 3 steps)
    with Adan, amp and random erasing, then ``--test-only --resume``."""
    if native and not data.native_available():
        pytest.skip("the native decoder cannot be built here (no g++ or libjpeg)")
    root = tmp_path / "data"
    _write_folder(root)
    if native:
        (root / "train" / "class0" / "0.png").unlink()
    steps = _steps(monkeypatch)
    ckpt = tmp_path / "folder.pt"
    argv = [str(root), "--arch", "convnext_atto", "--opt", "adan", "--amp", "--random-erase", "0.5", "--epochs", "1",
            "--output-file", str(ckpt), *COMMON]
    trainer = train.main(train.parse_args(argv))
    out = capsys.readouterr().out
    assert ("native decoder" in out) == native and ("PIL" in out) == (not native)
    assert len(steps) == (2 if native else 3) and all(s[0] == (4, 3, 32, 32) for s in steps)
    assert all(s[1] == (torch.uint8 if native else torch.float32) for s in steps)
    assert (trainer.input_norm is not None) == native
    resumed = train.main(train.parse_args([*argv, "--test-only", "--resume", str(ckpt)]))
    assert "Validation loss" in capsys.readouterr().out
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_main_actions(monkeypatch, tmp_path, capsys):
    """``--find-size`` on a folder (the untransformed images' median, as
    ``find_image_size`` computes it), ``--find-lr`` and ``--check-setup`` on ``fake``."""
    import matplotlib

    matplotlib.use("Agg")
    root = tmp_path / "data"
    _write_folder(root)
    found, find = [], utils.find_image_size
    monkeypatch.setattr(utils, "find_image_size", lambda dataset: found.append(find(dataset)))
    assert train.main(train.parse_args([str(root), "--find-size", *COMMON])) is None
    folder = data.ImageFolder(root / "train")
    assert found == [find([folder[i] for i in range(len(folder))])]
    fake = ["fake", "--arch", "convnext_atto", "--fake-samples", "8", "--train-crop-size", "32", *COMMON[:6]]
    trainer = train.main(train.parse_args([*fake, "--find-lr"]))
    assert len(trainer.lr_recorder) == len(trainer.loss_recorder) == 2
    assert "lr=" in capsys.readouterr().out
    train.main(train.parse_args([*fake, "--check-setup"]))
    assert "overfit-one-batch losses" in capsys.readouterr().out


def test_main_refuses_what_the_port_does_not_run(tmp_path, offline):
    with pytest.raises(SystemExit, match="--pretrained"):
        train.main(train.parse_args(["fake", "--arch", "mobileone_s0", "--pretrained", "--fake-samples", "8",
                                     *COMMON]))
    # the flags are passed on: one process cannot host a factor of 2
    for flag in (["--model-parallel", "2"], ["--spatial-parallel", "2"]):
        with pytest.raises(ValueError, match="cannot host a (model|spatial)-parallel factor of 2"):
            train.main(train.parse_args(["fake", *flag, *COMMON]))
    # ZeRO-1 is accepted (inert in one process)
    trainer = train.main(train.parse_args(["fake", "--shard-opt-state", "--test-only", "--fake-samples", "8", *COMMON]))
    assert trainer.shard_opt_state and trainer.world_size == 1


def test_epoch_reaches_spawned_workers():
    """Mixup under the CLI's collate, in one spawned worker: each epoch's batch differs
    from the last (the epoch is set before the worker receives the collate), and a new
    loader on the same seed draws the same first epoch."""

    def epochs(n):
        loader = data.EpochDataLoader(data.SyntheticDataset(4, (3, 4, 4)), 4, num_workers=1,
                                      collate_fn=train.MixupCollate(data.default_collate, 10, 0.4, seed=0))
        return [next(iter(loader))[0] for _ in range(n)]

    first, second = epochs(2), epochs(1)
    assert not torch.equal(first[0], first[1])
    assert torch.equal(first[0], second[0])
    with pytest.raises(ValueError, match="persistent"):
        data.EpochDataLoader(data.SyntheticDataset(4, (3, 4, 4)), 4, num_workers=1, persistent_workers=True)
