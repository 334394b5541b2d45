"""The port's ``bench_b1`` against ``scripts/bench_b1.py`` on the CPU.

The JAX script is loaded from its file. Both build a small RepVGG under the name
``repvgg_a0`` (``RepVGG([1], [8], 1.0, 1.0)``, 32 px, bf16, reparametrized), and both
profilers are replaced by one that reports a fixed device time, so that the rows can be
held key for key: the same keys (the port's adds ``device``), the same reference
figures, parameter count and speedup. The port's own profiler runs in the sweep test.
"""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import holocron_tpu.models as jax_models
import holocron_tpu.utils.profiling as jax_profiling
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu_torch import bench_b1, gen_bench_table
from holocron_tpu_torch import models as port_models
from holocron_tpu_torch.models import RepVGG

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CFG = ([1], [8], 1.0, 1.0)
SIZE = 32


def _load_script():
    spec = importlib.util.spec_from_file_location("jax_bench_b1", ROOT / "scripts" / "bench_b1.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_B1 = _load_script()


def test_reference_tables_equal_the_scripts():
    assert bench_b1.REFERENCE_B1_MS == JAX_B1.REFERENCE_B1_MS
    assert bench_b1.DEFAULT_SIZES == JAX_B1.DEFAULT_SIZES


@pytest.fixture
def tiny(monkeypatch):
    """``repvgg_a0`` is the small RepVGG in both packages."""
    monkeypatch.setattr(jax_models, "repvgg_a0", lambda dtype=None: Model(JaxRepVGG(*CFG, dtype=dtype)),
                        raising=False)
    monkeypatch.setattr(port_models, "repvgg_a0", lambda **kwargs: RepVGG(*CFG, **kwargs), raising=False)

    def fixed(ms):
        summary = {"ms_per_iter": ms, "wall_ms_per_iter": ms, "ops": {}}
        monkeypatch.setattr(jax_profiling, "device_op_summary", lambda *args, **kwargs: summary)
        monkeypatch.setattr(bench_b1, "device_op_summary", lambda *args, **kwargs: summary)

    return fixed


@pytest.mark.parametrize("ms", [0.1409, 0.0], ids=["timed", "no-device-time"])
def test_row_matches_the_scripts(tiny, ms):
    """The same keys and values, ``form`` and ``device`` apart; ``speedup_vs_ref_gpu`` is
    the reference's GPU ms over ``device_ms``, rounded to 0.1, and left out where the
    trace holds no device time."""
    tiny(ms)
    theirs = JAX_B1.bench_one("repvgg_a0", SIZE, 2)
    ours = bench_b1.bench_one("repvgg_a0", SIZE, 2, "cpu")
    assert set(ours) == set(theirs) | {"device"}
    assert ours["form"] == "eager" and theirs["form"] == "const" and ours["device"] == "cpu"
    for key in set(theirs) - {"form", "queued_ms"}:
        assert ours[key] == theirs[key], key
    assert ours["queued_ms"] > 0
    assert ("speedup_vs_ref_gpu" in ours) == (ms > 0)
    if ms:
        assert ours["speedup_vs_ref_gpu"] == round(3.14 / ms, 1) == 22.3


def test_sweep_rows_render_as_the_b1_table(tmp_path):
    """A sweep on the CPU through the port's profiler (the host's operators stand in for
    kernels there): rows appended to ``--out``, an arch that fails written as an error
    row, and ``gen_bench_table --b1`` rendering the others beside the reference."""
    out = tmp_path / "b1.jsonl"
    rows = bench_b1.main(bench_b1.parse_args(["--archs", "repvgg_a0", "no_such_arch", "--size", str(SIZE), "--it",
                                              "2", "--device", "cpu", "--out", str(out)]))
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows
    good, bad = rows
    assert bad["arch"] == "no_such_arch" and "error" in bad
    assert good["device_ms"] > 0 and good["speedup_vs_ref_gpu"] == round(3.14 / good["device_ms"], 1)
    lines = gen_bench_table.main_b1(SimpleNamespace(jsonl=str(out)))
    assert len(lines) == 3 and lines[2].startswith(f"| repvgg_a0 | {good['device_ms']:.3f} | 3.14 | 23.28 |")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_b1.main(bench_b1.parse_args(["--archs", "repvgg_a0"]))



def test_b1_table_gives_no_speedup_where_the_kernels_outlast_the_queue(tmp_path):
    """A row whose kernel sum is above its queued time (``device_ms_exceeds_queued``,
    set on the card only) keeps its figures in the ``--b1`` table but no speedup."""
    out = tmp_path / "b1.jsonl"
    rows = [{"arch": "pyconv_resnet50", "device_ms": 5.1822, "queued_ms": 3.936, "ref_gpu_ms": 20.03,
             "ref_cpu_ms": 178.85, "speedup_vs_ref_gpu": 3.9, "device_ms_exceeds_queued": True,
             "device": "NVIDIA H100 80GB HBM3, 700.00 W"},
            {"arch": "repvgg_a0", "device_ms": 0.322, "queued_ms": 0.328, "ref_gpu_ms": 3.14, "ref_cpu_ms": 23.28,
             "speedup_vs_ref_gpu": 9.8, "device": "NVIDIA H100 80GB HBM3, 700.00 W"}]
    out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    lines = gen_bench_table.main_b1(SimpleNamespace(jsonl=str(out)))
    assert lines[2] == "| repvgg_a0 | 0.322 | 3.14 | 23.28 | **9.8x** |"
    assert lines[3] == "| pyconv_resnet50 | 5.182 | 20.03 | 178.85 | — (device ms above queued 3.936) |"
