"""The port's loading of released checkpoints against the JAX package's, on the CPU.

Every checkpoint here is a ``.pth`` written with ``torch.save`` into the test's
directory and read through a ``file://`` URL; ``urllib.request.urlopen`` is replaced by
one that refuses wherever a release URL is asked for, so that no test reaches the
network. The cache is ``$HOLOCRON_CACHE_DIR`` under the test's directory. Logits of the
two packages on the same file agree within 1e-4 (float32, the JAX converter's NHWC
layout against NCHW).
"""

import hashlib
import inspect
import json
import sys
import types
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu import models as jax_models
from holocron_tpu.models import utils as jax_utils
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu_torch import models
from holocron_tpu_torch.models import checkpoints, utils
from holocron_tpu_torch.models.classification import DarknetV2, RepVGG
from holocron_tpu_torch.models.detection import YOLOv2, yolov2
from holocron_tpu_torch.models.layers import FrozenBatchNorm2d

torch.set_num_threads(2)

CFG = ([1, 1], [8, 16], 1.0, 1.0)
NEW_ENUMS = ["RepVGG_A0_Checkpoint", "RepVGG_A1_Checkpoint", "RepVGG_A2_Checkpoint", "RepVGG_B0_Checkpoint",
             "RepVGG_B1_Checkpoint", "RepVGG_B2_Checkpoint", "MobileOne_S0_Checkpoint", "MobileOne_S1_Checkpoint",
             "MobileOne_S2_Checkpoint", "MobileOne_S3_Checkpoint", "ConvNeXt_Atto_Checkpoint", "Darknet19_Checkpoint",
             "Darknet53_Checkpoint", "CSPDarknet53_Checkpoint", "CSPDarknet53_Mish_Checkpoint"]
SMALL_DARKNET = [(8, 0), (16, 1), (32, 1)]
YOLOV2_MODULE = sys.modules["holocron_tpu_torch.models.detection.yolov2"]  # the package binds the factory's name


@pytest.fixture
def cache(monkeypatch, tmp_path):
    """An empty cache, and no network: fetching an http(s) URL raises as it does
    offline; ``file://`` URLs are read."""
    real = urllib.request.urlopen

    def local_only(url, *args, **kwargs):
        if not str(url).startswith("file:"):
            raise OSError("no network in the tests")
        return real(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", local_only)
    monkeypatch.setenv("HOLOCRON_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path


def _tiny_repvgg(seed: int) -> RepVGG:
    model = RepVGG(*CFG, num_classes=5, device="cpu", generator=torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5, generator=torch.Generator().manual_seed(seed + 1))
                m.running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(seed + 2))
    return model


def _saved(obj, path: Path) -> str:
    torch.save(obj, path)
    return path.as_uri()


def _x(seed: int = 0, size: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(2, 3, size, size)).astype(np.float32)


def test_repvgg_file_gives_the_jax_logits(cache):
    """A ``.pth`` of a tiny RepVGG: the port's ``load_pretrained_params`` gives the saved
    model's logits exactly, the JAX one the same within 1e-4, from one cached file."""
    source = _tiny_repvgg(0)
    url = _saved(source.state_dict(), cache / "repvgg_tiny.pth")
    ours = _tiny_repvgg(7)
    utils.load_pretrained_params(ours, url)
    jm = Model(JaxRepVGG(*CFG, num_classes=5))
    jax_utils.load_pretrained_params(jm, url=url)
    assert ours.pretrained_loaded and jm.pretrained_loaded
    x = _x()
    with torch.no_grad():
        expected = source(torch.from_numpy(x))
        got = ours(torch.from_numpy(x))
    assert torch.equal(got, expected)
    np.testing.assert_allclose(np.asarray(jm(jnp.asarray(x.transpose(0, 2, 3, 1)))), got.numpy(), rtol=0, atol=1e-4)
    assert len(list((cache / "cache" / "checkpoints").iterdir())) == 1


def test_checkpoint_argument_checks_the_hash(cache):
    """A factory's ``checkpoint=`` loads its URL and checks its sha256 (the file's real
    one loads; a wrong one leaves the weights drawn and ``pretrained_loaded`` False, as
    the JAX package's does)."""
    path = cache / "repvgg_a0.pth"
    source = models.repvgg_a0(device="cpu", generator=torch.Generator().manual_seed(3)).eval()
    url = _saved(source.state_dict(), path)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    ckpt = utils._checkpoint("repvgg_a0", url, 0.0, 0.0, digest, path.stat().st_size, 0)
    loaded = models.repvgg_a0(checkpoint=ckpt, progress=False, device="cpu").eval()
    assert loaded.pretrained_loaded and loaded.default_cfg is ckpt
    x = torch.from_numpy(_x(1, 64))
    with torch.no_grad():
        assert torch.equal(loaded(x), source(x))
    bad = utils._checkpoint("repvgg_a0", url, 0.0, 0.0, "0" * 64, 0, 0)
    drawn = models.repvgg_a0(checkpoint=bad, device="cpu", generator=torch.Generator().manual_seed(4))
    assert not drawn.pretrained_loaded
    assert torch.equal(drawn.head.weight, models.repvgg_a0(device="cpu", generator=torch.Generator().manual_seed(4))
                       .head.weight)
    jm = Model(JaxRepVGG(*CFG, num_classes=5))
    jax_utils.load_pretrained_params(jm, url=_saved(_tiny_repvgg(0).state_dict(), cache / "t.pth"), sha256="0" * 64)
    assert not jm.pretrained_loaded


def test_cache_path_is_shared_and_keyed_on_the_full_url(cache):
    """The same URL lands on the same cache file in both packages; two URLs with one
    basename do not share a file."""
    for d, data in (("v1", b"first release"), ("v2", b"second release")):
        (cache / d).mkdir()
        (cache / d / "model.pth").write_bytes(data)
    a, b = ((cache / d / "model.pth").as_uri() for d in ("v1", "v2"))
    ours_a, ours_b = utils._download_checkpoint(a), utils._download_checkpoint(b)
    assert ours_a == jax_utils._download_checkpoint(a) and ours_b == jax_utils._download_checkpoint(b)
    assert ours_a != ours_b and ours_a.read_bytes() == b"first release" and ours_b.read_bytes() == b"second release"
    assert ours_a.name.startswith(hashlib.sha256(a.encode()).hexdigest()[:16])


_RAN = []


def _mark(value):
    _RAN.append(value)
    return value


class _ArbitraryGlobal:
    def __reduce__(self):
        return (_mark, ("ran",))


def test_weights_only_refuses_an_arbitrary_global(cache):
    """A pickle carrying a global that is not a tensor or a plain container is refused
    before it runs: the load degrades to the drawn weights."""
    url = _saved({"head.weight": torch.zeros(5, 16), "extra": _ArbitraryGlobal()}, cache / "evil.pth")
    model = _tiny_repvgg(0)
    before = model.head.weight.clone()
    utils.load_pretrained_params(model, url)
    assert not model.pretrained_loaded and not _RAN and torch.equal(model.head.weight, before)


def test_trainer_checkpoint_is_unwrapped(cache):
    source = _tiny_repvgg(0)
    url = _saved({"epoch": 3, "step": 12, "min_loss": 0.5, "model": source.state_dict()}, cache / "trainer.pt")
    model = _tiny_repvgg(9)
    utils.load_pretrained_params(model, url)
    assert model.pretrained_loaded
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_backbone_file_grafts_onto_yolov2(cache):
    """``key_filter="features."`` puts a darknet19 file's body into YOLOv2's backbone
    (its frozen BN drops the counters), the rest of the detector as drawn; a key that
    names nothing raises. The factory's ``pretrained_backbone`` does the same from
    ``default_cfgs["yolov2"]["backbone_url"]`` at full width."""
    dark = DarknetV2(SMALL_DARKNET, num_classes=4, device="cpu", generator=torch.Generator().manual_seed(0))
    url = _saved(dark.state_dict(), cache / "darknet_small.pth")
    det = YOLOv2(SMALL_DARKNET, num_classes=3, backbone_norm_layer=FrozenBatchNorm2d, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    head = {k: v.clone() for k, v in det.state_dict().items() if not k.startswith("backbone.")}
    utils.load_pretrained_params(det, url, key_filter="features.", key_replacement=("features.", "backbone."))
    assert det.pretrained_loaded
    state = det.state_dict()
    for k, v in dark.state_dict().items():
        if k.startswith("features.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(state[k.replace("features.", "backbone.", 1)], v), k
    assert all(torch.equal(state[k], v) for k, v in head.items())
    bogus = _saved({**dark.state_dict(), "features.bogus": torch.zeros(1)}, cache / "bogus.pth")
    with pytest.raises(KeyError, match="features.bogus|backbone.bogus"):
        utils.load_pretrained_params(det, bogus, key_filter="features.", key_replacement=("features.", "backbone."))

    full = models.darknet19(device="cpu", generator=torch.Generator().manual_seed(2))
    cfg = {**YOLOV2_MODULE.default_cfgs["yolov2"], "backbone_url": _saved(full.state_dict(), cache / "darknet19.pth")}
    YOLOV2_MODULE.default_cfgs["yolov2"], saved_cfg = cfg, YOLOV2_MODULE.default_cfgs["yolov2"]
    try:
        model = yolov2(num_classes=20, device="cpu")
    finally:
        YOLOV2_MODULE.default_cfgs["yolov2"] = saved_cfg
    assert model.pretrained_loaded
    assert torch.equal(model.backbone.stem[0].weight, full.features.stem[0].weight)


def test_model_from_hf_hub_equals_jax(cache, monkeypatch):
    """``model_from_hf_hub`` behind a stub ``huggingface_hub`` that serves local files:
    the same architecture, classes and logits as the JAX package's on the same stub
    (the saved model's logits exactly, the JAX ones within 1e-5 of their scale)."""
    source = models.mobileone_s0(num_classes=3, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    files = {"pytorch_model.bin": cache / "pytorch_model.bin", "config.json": cache / "config.json"}
    torch.save(source.state_dict(), files["pytorch_model.bin"])
    files["config.json"].write_text(json.dumps({"arch": "mobileone_s0", "classes": ["a", "b", "c"],
                                                "input_shape": [3, 32, 32], "mean": [0.5] * 3, "std": [0.25] * 3}))
    stub = types.ModuleType("huggingface_hub")
    stub.hf_hub_download = lambda repo_id, filename, **kwargs: str(files[filename])
    monkeypatch.setitem(sys.modules, "huggingface_hub", stub)
    ours = utils.model_from_hf_hub("holocron/mobileone_s0", device="cpu").eval()
    theirs = jax_utils.model_from_hf_hub("holocron/mobileone_s0")
    assert ours.default_cfg.meta.categories == ["a", "b", "c"] and ours.default_cfg.pre_processing.input_shape == (3, 32, 32)
    x = _x(2, 32)
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
        assert torch.equal(got, source(torch.from_numpy(x)))
    # an untrained MobileOne's logits reach 1e4 (batch norm at its initial statistics):
    # held within 1e-5 of their largest magnitude, float32's rounding through its depth
    scale = float(got.abs().max())
    np.testing.assert_allclose(np.asarray(theirs(jnp.asarray(x.transpose(0, 2, 3, 1)))), got.numpy(), rtol=0,
                               atol=1e-5 * scale)


def _factories():
    out = []
    for family in (models.classification, models.detection, models.segmentation):
        for name, fn in vars(family).items():
            if inspect.isfunction(fn) and not name.startswith("_") and "pretrained" in inspect.signature(fn).parameters:
                out.append(name)
    return sorted(set(out))


def test_every_factory_takes_checkpoint_and_progress(cache):
    """Every classification, detection and segmentation factory takes ``checkpoint=``
    and ``progress=``. ``pretrained=True`` never raises: offline, a factory of each
    family not covered by its own test (the ResNet, ReXNet, RepVGG, darknet and
    detection tests build theirs) falls back to its drawn weights with
    ``pretrained_loaded`` False, a release URL or none."""
    names = _factories()
    assert len(names) == 56
    for name in names:
        params = inspect.signature(getattr(models, name)).parameters
        assert "checkpoint" in params and "progress" in params, name
    for name in ("mobileone_s0", "convnext_atto", "unet_rexnet13", "unetp", "unet3p"):
        model = getattr(models, name)(pretrained=True, progress=False, device="meta")
        assert model.pretrained_loaded is False and model.default_cfg is not None, name


def test_new_enums_equal_jax():
    """The 15 checkpoint enums this slice copies: the same URL, sha256, size, parameter
    count and training recipe as the JAX package's; the input shape channel-first."""
    for name in NEW_ENUMS:
        ours, theirs = getattr(models, name).DEFAULT.value, getattr(jax_models, name).DEFAULT.value
        assert (ours.meta.url, ours.meta.sha256, ours.meta.size, ours.meta.num_params, ours.meta.arch) == (
            theirs.meta.url, theirs.meta.sha256, theirs.meta.size, theirs.meta.num_params, theirs.meta.arch), name
        assert (ours.recipe.commit, ours.recipe.args) == (theirs.recipe.commit, theirs.recipe.args), name
        assert ours.evaluation.results == theirs.evaluation.results, name
        assert ours.pre_processing.input_shape == (3, 224, 224) and theirs.pre_processing.input_shape == (224, 224, 3)
    assert checkpoints._handle_legacy_pretrained(True, None, None) is None
