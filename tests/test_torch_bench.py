"""The port's headline bench (``holocron_tpu_torch.bench``) on the CPU at a tiny size,
its accuracy gate and cuDNN settings, and the card's int8 verdicts
(``quant.recommended_quantization``)."""

import functools
import json
from pathlib import Path

import pytest
import torch

from holocron_tpu_torch import bench, quant

torch.set_num_threads(2)

TINY = {"device": "cpu", "size": 32, "iters": 2, "warmup": 1}
POLICY = Path(quant.__file__).resolve().parent / "models" / "_data" / "quant_policy.json"
# the card's verdicts (quant_policy.json) for repvgg_a0, resnet50, rexnet1_0x, darknet53,
# yolov4, unet3p, mobileone_s1 and convnext_tiny
RECOMMENDED = [True, False, False, False, False, False, True, True]


@pytest.fixture
def tiny(monkeypatch):
    """bench.run at a CPU size, with its calls to throughput recorded."""
    calls = []
    throughput = bench.throughput

    def recorded(fwd, x, iters, warmup):
        calls.append(x.shape[0])
        return throughput(fwd, x, iters, warmup)

    monkeypatch.setattr(bench, "throughput", recorded)
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, **TINY))
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    return calls


def test_bench_prints_one_json_line(tiny, capsys, monkeypatch):
    """``python -m holocron_tpu_torch.bench`` prints one line: metric, value, unit and a
    null vs_baseline (the port carries no TPU target). With the gate passed (floor 0),
    both forms are timed and the faster one is the value."""
    monkeypatch.setenv("HOLOCRON_INT8_AGREEMENT", "0")
    bench.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["vs_baseline"] is None and line["unit"] == "images/sec/chip" and line["value"] > 0
    assert line["metric"].startswith("repvgg_a0 32px inference throughput, best accuracy-gated deploy form = ")
    assert "(batch=2; bf16 " in line["metric"] and "int8 top-1 agreement" in line["metric"]
    assert tiny == [2, 2]


def test_gate_below_the_floor_keeps_bf16(tiny, monkeypatch):
    """An int8 form whose agreement is below the floor is not timed: the headline is
    bf16."""
    monkeypatch.setattr(bench, "measure_agreement", lambda *a: {"top1_agreement": 0.5, "max_prob_drift": 1.0})
    result = bench.run("repvgg_a0", batch=2)
    assert tiny == [2]
    assert result["int8_img_per_s"] == 0.0 and result["int8_error"] is None
    assert result["value"] == round(result["bf16_img_per_s"], 1)
    assert "deploy form = bf16" in result["metric"] and "agreement 0.500 (gate >=0.99)" in result["metric"]


def test_int8_failure_leaves_the_headline(tiny, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "quantize_model", broken)
    result = bench.run("repvgg_a0", batch=2)
    assert tiny == [2] and result["agreement"] is None and "boom" in result["int8_error"]
    assert "deploy form = bf16" in result["metric"]


def test_gate_and_timing_cudnn_settings(tiny, monkeypatch):
    """The gate's forwards run with cuDNN's benchmark off and deterministic on, the
    timed forwards are captured with benchmark on; the flags are restored after."""
    seen = {}
    agreement = bench.measure_agreement
    deploy_forward = bench.deploy_forward

    def gate(*args):
        seen["gate"] = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
        return agreement(*args)

    def capture(*args, **kwargs):
        seen.setdefault("capture", []).append((torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic))
        return deploy_forward(*args, **kwargs)

    monkeypatch.setattr(bench, "measure_agreement", gate)
    monkeypatch.setattr(bench, "deploy_forward", capture)
    before = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    result = bench.run("rexnet1_0x", batch=2, agreement_floor=0.0)
    assert seen == {"gate": (False, True), "capture": [(True, False), (True, False)]}
    assert (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic) == before
    assert result["agreement"]["top1_agreement"] == 1.0 and result["int8_img_per_s"] > 0


def test_recommended_quantization_reads_the_card_verdicts():
    """The archs the card measured have verdicts, read from the port's generated
    ``models/_data/quant_policy.json`` (recommended at >= 1.05, the JAX policy's rule,
    unless a quality veto pins it off); any other returns None. The verdicts are a table
    of their own, not fields of QUANT_POLICY (the JAX file's copy)."""
    policy = json.loads(POLICY.read_text())
    archs = ("repvgg_a0", "resnet50", "rexnet1_0x", "darknet53", "yolov4", "unet3p", "mobileone_s1", "convnext_tiny")
    verdicts = {arch: quant.recommended_quantization(arch) for arch in archs}
    assert all(set(v) == {"int8_speedup", "recommended"} for v in verdicts.values())
    assert all(v == {k: policy[arch][k] for k in v} for arch, v in verdicts.items())
    assert all(v["recommended"] == (v["int8_speedup"] >= 1.05 and "quality_veto" not in policy[arch])
               for arch, v in verdicts.items())
    assert [v["recommended"] for v in verdicts.values()] == RECOMMENDED
    for arch in ("not_an_arch", "repvgg_a0_s2d"):
        assert quant.recommended_quantization(arch) is None
    assert not any("int8_speedup" in e or "recommended" in e for e in quant.QUANT_POLICY.values())
    quant.recommended_quantization("repvgg_a0")["recommended"] = False  # a copy
    assert quant.recommended_quantization("repvgg_a0")["recommended"]


def test_packaged_policy_loads_and_recommends_only_fast_unvetoed_archs():
    """The packaged quant_policy.json loads: every arch has its speed fields, every
    recommended one runs int8 at 1.05x bf16 or more with no quality veto, and every veto
    quotes a row of the card's own quant_accuracy."""
    policy = json.loads(POLICY.read_text())
    assert len(policy) > 8 and all({"int8_speedup", "recommended"} <= set(e) for e in policy.values())
    recommended = [e for e in policy.values() if e["recommended"]]
    assert recommended and all(e["int8_speedup"] >= 1.05 and "quality_veto" not in e for e in recommended)
    vetoes = [e["quality_veto"] for e in policy.values() if "quality_veto" in e]
    assert vetoes and all("quant_accuracy" in v and "H100" in v for v in vetoes)
    assert quant.INT8_VERDICTS.keys() == policy.keys()
