"""The port's script modules against the JAX package's scripts on the CPU:
``gen_quant_policy``, ``gen_bench_table``, ``bench_input_pipeline`` and ``demo``.

Each JAX script is loaded from its file (as ``tests/test_scripts.py`` does) and given the
same inputs as its port: the same policy dict from the same rows (exactly), the same
table rows from the same JSONL (text for text), the same dataset bytes, the same val
transform within 1e-6, the same top-3 from the same probabilities (exactly), with gradio
and the service's batcher stubbed. Nothing here needs the native decoder, gradio, a GPU
or the network.
"""

import importlib.util
import io
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from holocron_tpu_torch import bench_input_pipeline, demo, gen_bench_table, gen_quant_policy, quant

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _load(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jsonl(path: Path, rows) -> None:
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


# --- gen_quant_policy ---


def _policies(monkeypatch, tmp_path, bf16_rows, int8_rows, **tables):
    """Both generators over the same rows, their BENCH and OUT under ``tmp_path``."""
    jax_gen = _load("scripts/gen_quant_policy.py", "jax_gen_quant_policy")
    out = {}
    for side, mod in (("jax", jax_gen), ("port", gen_quant_policy)):
        bench = tmp_path / side / "bench"
        bench.mkdir(parents=True)
        _jsonl(bench / mod.BF16[0], bf16_rows)
        _jsonl(bench / mod.INT8[0], int8_rows)
        monkeypatch.setattr(mod, "BENCH", bench)
        monkeypatch.setattr(mod, "OUT", tmp_path / side / "quant_policy.json")
        for name, value in tables.items():
            monkeypatch.setattr(mod, name, value)
        mod.main()
        out[side] = json.loads(mod.OUT.read_text())
    return out["jax"], out["port"]


def test_gen_quant_policy_overrides_and_veto_match_jax(monkeypatch, tmp_path, capsys):
    """``tests/test_scripts.py::test_gen_quant_policy_overrides_and_veto`` on both: a
    speed win is recommended, the floor and stride overrides attach their keys, a veto
    pins ``recommended: false`` whatever the speed; the same dict from both."""
    bf16 = [{"arch": a, "img_per_sec": 100.0} for a in ("fast", "slow", "vetoed")]
    int8 = [{"arch": "fast", "img_per_sec": 200.0}, {"arch": "slow", "img_per_sec": 80.0},
            {"arch": "vetoed", "img_per_sec": 200.0}, {"arch": "int8_only", "img_per_sec": 1.0}]
    theirs, ours = _policies(monkeypatch, tmp_path, bf16, int8,
                             MIN_IN_CHANNELS_OVERRIDES={"fast": 48},
                             STRIDE_POLICY_OVERRIDES={"fast": {"quantize_strided": False}},
                             QUALITY_GATE_VETOES={"vetoed": "synthetic agreement failure (test)"})
    capsys.readouterr()
    assert ours == theirs
    assert ours["fast"] == {"int8_speedup": 2.0, "recommended": True, "min_in_channels": 48,
                            "quantize_strided": False}
    assert ours["slow"]["recommended"] is False and "quality_veto" not in ours["slow"]
    assert ours["vetoed"] == {"int8_speedup": 2.0, "recommended": False,
                              "quality_veto": "synthetic agreement failure (test)"}
    assert "int8_only" not in ours


def test_gen_quant_policy_best_row_and_threshold_match_jax(monkeypatch, tmp_path, capsys):
    """Several rows an arch (the best of each form counts), error rows skipped, and the
    1.05 threshold on both sides of it."""
    bf16 = [{"arch": "a", "img_per_sec": 100.0}, {"arch": "a", "img_per_sec": 120.0},
            {"arch": "b", "img_per_sec": 100.0}, {"arch": "c", "error": "RuntimeError: boom"},
            {"arch": "c", "img_per_sec": 10.0}]
    int8 = [{"arch": "a", "img_per_sec": 126.0}, {"arch": "b", "img_per_sec": 104.9},
            {"arch": "b", "error": "x"}, {"arch": "c", "img_per_sec": 10.5}]
    theirs, ours = _policies(monkeypatch, tmp_path, bf16, int8, MIN_IN_CHANNELS_OVERRIDES={},
                             QUALITY_GATE_VETOES={})
    capsys.readouterr()
    assert ours == theirs
    assert [ours[a]["recommended"] for a in "abc"] == [True, False, True]


def test_packaged_policy_is_the_generated_one(monkeypatch, tmp_path, capsys):
    """Regenerating from the committed rows gives the committed quant_policy.json, and
    quant.INT8_VERDICTS holds its speed fields."""
    monkeypatch.setattr(gen_quant_policy, "OUT", tmp_path / "quant_policy.json")
    policy = gen_quant_policy.main()
    capsys.readouterr()
    assert policy == json.loads((gen_quant_policy.DATA / "quant_policy.json").read_text())
    assert quant.INT8_VERDICTS == {a: {"int8_speedup": e["int8_speedup"], "recommended": e["recommended"]}
                                   for a, e in policy.items()}


_GATES = ("top1_agreement", "mean_mask_iou", "det_f1")  # each task's agreement, held at 0.99


def test_vetoes_follow_the_longest_trained_rows():
    """An arch is vetoed exactly where its longest-trained row of the card's own
    quant_accuracy fails its gate, and its veto quotes that row's agreement, steps and
    card."""
    longest = {}
    for path in sorted(gen_quant_policy.BENCH.glob("quant_accuracy*.jsonl")):
        for line in path.read_text().splitlines():
            row = json.loads(line)
            if row["steps"] >= longest.get(row["arch"], {"steps": -1})["steps"]:
                longest[row["arch"]] = row
    assert len(longest) == 13
    gate = {arch: next(row[k] for k in _GATES if k in row) for arch, row in longest.items()}
    assert set(gen_quant_policy.QUALITY_GATE_VETOES) == {arch for arch, value in gate.items() if value < 0.99}
    for arch, reason in gen_quant_policy.QUALITY_GATE_VETOES.items():
        row = longest[arch]
        assert f"= {gate[arch]}" in reason and f"{row['steps']} steps" in reason and row["device"] in reason, arch


# --- gen_bench_table ---


def _zoo_rows():
    rng = np.random.default_rng(0)
    archs = ["repvgg_a0", "resnet50", "rexnet1_0x", "darknet53", "mobileone_s1", "convnext_tiny"]
    bf16 = [{"arch": a, "task": "classification", "batch": 128, "size": 224, "dtype": "bfloat16",
             "mean_ms": float(rng.uniform(2, 20)), "params_m": float(rng.uniform(1, 90)),
             "img_per_sec": float(rng.uniform(5e3, 4e4)), "device": "NVIDIA H100 80GB HBM3, 700.00 W"} for a in archs]
    int8 = [{**r, "img_per_sec": r["img_per_sec"] * f, "quantized": True}
            for r, f in zip(bf16, (1.3, 0.8, 1.01, 1.03, 1.1, 0.9))]
    return bf16 + [{"arch": "sknet50", "error": "boom"}], int8


@pytest.mark.parametrize("quantized", [False, True])
def test_gen_bench_table_rows_match_jax(tmp_path, capsys, quantized):
    bf16, int8 = _zoo_rows()
    _jsonl(tmp_path / "bf16.jsonl", bf16)
    _jsonl(tmp_path / "int8.jsonl", int8)
    argv = [str(tmp_path / "bf16.jsonl")] + (["--quant", str(tmp_path / "int8.jsonl")] if quantized else [])
    jax_table = _load("scripts/gen_bench_table.py", "jax_gen_bench_table")
    capsys.readouterr()
    jax_table.main(types.SimpleNamespace(jsonl=argv[0], quant=argv[2] if quantized else None, b1=False))
    theirs = capsys.readouterr().out.splitlines()
    ours = gen_bench_table.main(gen_bench_table.parse_args(argv))
    capsys.readouterr()
    assert ours[2:] == theirs[2:] and len(ours) == 8  # the rows; the headers name the card
    assert "H100" in ours[0] and "RTX 2070" in ours[0] and jax_table.REF_GPU_MS == gen_bench_table.REF_GPU_MS


def test_gen_bench_table_b1_rows_match_jax(tmp_path, capsys):
    rows = [{"arch": "repvgg_a0", "device_ms": 0.61, "ref_gpu_ms": 3.14, "ref_cpu_ms": 11.0,
             "speedup_vs_ref_gpu": 5.1, "device": "NVIDIA H100 80GB HBM3, 700.00 W"},
            {"arch": "resnet18", "device_ms": 0.42}]
    _jsonl(tmp_path / "b1.jsonl", rows)
    jax_table = _load("scripts/gen_bench_table.py", "jax_gen_bench_table")
    capsys.readouterr()
    jax_table.main_b1(types.SimpleNamespace(jsonl=str(tmp_path / "b1.jsonl")))
    theirs = capsys.readouterr().out.splitlines()
    ours = gen_bench_table.main_b1(gen_bench_table.parse_args([str(tmp_path / "b1.jsonl"), "--b1"]))
    assert ours[2:] == theirs[2:] and ours[2].startswith("| resnet18 |")


# --- bench_input_pipeline ---


def test_synthesized_dataset_is_byte_identical(tmp_path):
    jax_bench = _load("scripts/bench_input_pipeline.py", "jax_bench_input_pipeline")
    jax_bench.synthesize_dataset(tmp_path / "jax", 8)
    bench_input_pipeline.synthesize_dataset(tmp_path / "port", 8)
    theirs = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.jpg"))
    ours = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.jpg"))
    assert ours == theirs and len(ours) == 8 + 16
    assert all((tmp_path / "port" / p).read_bytes() == (tmp_path / "jax" / p).read_bytes() for p in ours)


def test_pil_val_transform_matches_jax(tmp_path):
    """The val transform of the loaders the CLI builds, on one image, against the JAX
    script's ``pil_val_tf`` (``bench_input_pipeline.py:84-88``: its Resize,
    normalize_image and crop)."""
    from PIL import Image

    from holocron_tpu.transforms import Resize
    from holocron_tpu.utils.data import normalize_image
    from holocron_tpu_torch.models.presets import IMAGENETTE

    bench_input_pipeline.synthesize_dataset(tmp_path, 8)
    args = bench_input_pipeline.parse_args(["--workers", "0"])
    val_tf = bench_input_pipeline.loaders(tmp_path, args, native=False)[1].dataset.transform
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, size=(300, 410, 3), dtype=np.uint8))
    theirs = np.asarray(normalize_image(Resize((232, 232))(img), IMAGENETTE.mean, IMAGENETTE.std))[4:228, 4:228]
    ours = val_tf(img)
    assert ours.shape == (224, 224, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def test_input_pipeline_bench_runs_pil_only(monkeypatch, capsys):
    """Without the native decoder (as on the card's machine) only the PIL figures."""
    import holocron_tpu_torch.utils.data as data

    monkeypatch.setattr(data, "native_available", lambda: False)
    args = bench_input_pipeline.parse_args(["--samples", "16", "--batch-size", "4", "--workers", "0",
                                            "--train-crop-size", "32"])
    results = bench_input_pipeline.main(args)
    assert set(results) == {"pil_train_imgs_per_s", "pil_val_imgs_per_s"} and min(results.values()) > 0
    assert "PIL numbers only" in capsys.readouterr().out


# --- demo ---


class _Batcher:
    def __init__(self, probs):
        self.probs, self.seen = probs, []

    def submit(self, x):
        self.seen.append(x)
        return {"probs": self.probs}


def _jax_predict(monkeypatch, batcher, classes):
    """The JAX demo's ``predict`` closure, with gradio and ``api.app.vision`` stubbed."""
    captured = {}

    class Interface:
        def __init__(self, fn, **kwargs):
            captured["fn"] = fn

        def launch(self, **kwargs):
            captured["launch"] = kwargs

    gradio = types.SimpleNamespace(Interface=Interface, Image=lambda **kw: None, Label=lambda **kw: None)
    vision = types.SimpleNamespace(CLASSES=classes, get_batcher=lambda: batcher)
    monkeypatch.setitem(sys.modules, "gradio", gradio)
    monkeypatch.setitem(sys.modules, "api", types.ModuleType("api"))
    monkeypatch.setitem(sys.modules, "api.app", types.ModuleType("api.app"))
    monkeypatch.setitem(sys.modules, "api.app.vision", vision)
    monkeypatch.setattr(sys, "path", list(sys.path))
    _load("demo/app.py", "jax_demo_app").main(types.SimpleNamespace(port=0, share=False))
    return captured["fn"]


@pytest.mark.parametrize("num_classes", [10, 4])
def test_demo_predict_matches_jax(monkeypatch, num_classes):
    """The same top-3 labels and probabilities from the same probabilities; an index
    past the class list is labelled by its number; the same uint8 224 px input."""
    from PIL import Image

    probs = np.random.default_rng(num_classes).dirichlet(np.ones(10)).astype(np.float32)
    classes = [f"class_{i}" for i in range(num_classes)]
    img = Image.fromarray(np.random.default_rng(2).integers(0, 256, size=(180, 260, 3), dtype=np.uint8))
    jax_batcher, port_batcher = _Batcher(probs), _Batcher(probs)
    theirs = _jax_predict(monkeypatch, jax_batcher, classes)(img)
    ours = demo.make_predict(port_batcher, classes)(img)
    assert list(ours.items()) == list(theirs.items()) and len(ours) == 3 and sum(ours.values()) <= 1.0
    assert np.array_equal(port_batcher.seen[0], jax_batcher.seen[0]) and port_batcher.seen[0].shape == (1, 224, 224, 3)


def test_demo_main_exits_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit, match="gradio is required"):
        demo.main(demo.parse_args(["--device", "cpu"]))


def test_demo_raises_without_the_card(monkeypatch):
    """With gradio present, the default device is the card: the service's model load
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from holocron_tpu_torch.api import config, vision

    monkeypatch.setitem(sys.modules, "gradio", types.SimpleNamespace())
    monkeypatch.setattr(config, "DEVICE", config.DEVICE)
    monkeypatch.setattr(vision, "BATCHER", None)
    monkeypatch.setattr(vision, "MODEL", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(demo.parse_args([]))


def test_image_bytes_roundtrip_for_the_demo():
    """A JPEG decoded by PIL goes through make_predict like an uploaded image."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(buf, format="JPEG")
    probs = np.linspace(0, 1, 10, dtype=np.float32)
    out = demo.make_predict(_Batcher(probs / probs.sum()), [str(i) for i in range(10)])(Image.open(buf))
    assert list(out) == ["9", "8", "7"]
