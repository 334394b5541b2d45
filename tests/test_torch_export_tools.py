"""The port's export, latency, zoo, profiling and checkpoint-cleaning tools on the CPU,
and its int8 custom ops.

On the CPU the ops take the kernels' plain versions; ``torch.library.opcheck`` holds
their schemas and fake implementations against them. An exported program, loaded back,
gives the eager module's outputs: within 1e-5 in float32, equal in int8 (the same ops
on the same inputs) and for the detectors' keep masks and labels.
"""

import json

import numpy as np
import pytest
import torch

from holocron_tpu_torch import bench_zoo, eval_latency, export, quant
from holocron_tpu_torch.kernels import int8_conv as K
from holocron_tpu_torch.models import RepVGG
from holocron_tpu_torch.models.detection import YOLOv2
from holocron_tpu_torch.references import clean_checkpoint
from holocron_tpu_torch.utils import profiling

torch.set_num_threads(2)

CFG = ([1, 1], [8, 16], 1.0, 1.0)


def _tiny(seed: int = 0) -> RepVGG:
    return RepVGG(*CFG, num_classes=5, device="cpu", generator=torch.Generator().manual_seed(seed))


def _x(size: int = 32) -> torch.Tensor:
    return torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(1))


def test_trace_device_ops_reads_kernels_and_ignores_the_host():
    """Kernel events summed by name; host operators, runtime calls and metadata events
    ignored where there is a kernel; a trace with none gives the host operators by self
    time (a parent's own time, its children's apart)."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 0, "dur": 5.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 9, "dur": 3.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "relu", "ts": 20, "dur": 1.5, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 40.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1, "dur": 4.0, "pid": 1, "tid": 1},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]}
    assert profiling.trace_device_ops(trace) == {"gemm": 8.0, "relu": 1.5}
    assert profiling.trace_kernels(trace) == [("gemm", 5.0), ("gemm", 3.0), ("relu", 1.5)]
    host = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 10.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mkldnn_convolution", "ts": 1, "dur": 7.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 2, "dur": 1.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "ts": 12, "dur": 2.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "forward", "ts": 0, "dur": 20.0, "pid": 1, "tid": 1},
    ]}
    assert profiling.trace_device_ops(host) == {"aten::conv2d": 3.0, "aten::mkldnn_convolution": 6.0,
                                                "aten::empty": 1.0, "aten::relu": 2.0}


@pytest.mark.parametrize("launch", ["cudaLaunchKernel", "cudaGraphLaunch"])
def test_trace_device_ops_refuses_launches_without_kernels(launch):
    """A trace that records launches on the card but no kernel (the profiler's device
    tracing failed) raises, in place of giving host times as device times; the same
    host operators without a launch are a run on the CPU."""
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 40.0, "pid": 1, "tid": 1}]
    lost = {"traceEvents": host + [
        {"ph": "X", "cat": "cuda_runtime", "name": launch, "ts": 1, "dur": 4.0, "pid": 1, "tid": 1}]}
    with pytest.raises(ValueError, match="no kernel"):
        profiling.trace_device_ops(lost)
    with pytest.raises(ValueError, match="no kernel"):
        profiling.trace_kernels(lost)
    assert profiling.trace_device_ops({"traceEvents": host}) == {"aten::mm": 40.0}
    assert profiling.trace_kernels({"traceEvents": host}) == []


def test_trace_kernels_counts_the_window_by_correlation():
    """With ``window``, only the kernels of the launches made inside the named
    ``record_function`` ranges count, a graph launch's kernels all of them; a launch in
    the window whose kernel the trace lost raises, one outside it does not; a trace
    without the range raises."""
    def launch(name, ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1.0, "pid": 1, "tid": 1,
                "args": {"correlation": corr}}

    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
                "args": {"correlation": corr}}

    window = {"ph": "X", "cat": "user_annotation", "name": profiling.WINDOW, "ts": 10, "dur": 20.0, "pid": 1,
              "tid": 1}
    events = [launch("cudaLaunchKernel", 2, 1), window, launch("cudaLaunchKernel", 12, 2),
              launch("cudaGraphLaunch", 20, 3), launch("cudaLaunchKernel", 40, 4),
              kernel("pad", 3, 9.0, 1), kernel("gemm", 13, 2.0, 2), kernel("a", 21, 1.0, 3), kernel("b", 23, 0.5, 3)]
    assert profiling.trace_kernels({"traceEvents": events}, window=profiling.WINDOW) == [
        ("gemm", 2.0), ("a", 1.0), ("b", 0.5)]
    assert profiling.trace_device_ops({"traceEvents": events}, window=profiling.WINDOW) == {
        "gemm": 2.0, "a": 1.0, "b": 0.5}
    assert len(profiling.trace_kernels({"traceEvents": events})) == 4  # launch 4's kernel lost: outside
    with pytest.raises(ValueError, match="lost the kernels of 1 of the 2"):
        profiling.trace_kernels({"traceEvents": [e for e in events if e["name"] != "gemm"]}, window=profiling.WINDOW)
    with pytest.raises(ValueError, match="no range"):
        profiling.trace_kernels({"traceEvents": [e for e in events if e is not window]}, window=profiling.WINDOW)


def test_device_op_summary_runs_on_the_cpu(tmp_path):
    model = _tiny().eval()
    summary = profiling.device_op_summary(model, _x(), iters=2, logdir=str(tmp_path))
    assert set(summary) == {"ms_per_iter", "wall_ms_per_iter", "ops"}
    assert summary["ms_per_iter"] > 0 and any("conv" in name for name in summary["ops"])
    assert (tmp_path / "trace.json").exists()
    assert abs(sum(summary["ops"].values()) / 2 / 1e3 - summary["ms_per_iter"]) < 1e-9


@pytest.mark.parametrize("c", [8, 20, 32])
def test_int8_ops_pass_opcheck_and_equal_the_plain_versions(c):
    """``holocron_tpu_torch::int8_quantize`` and ``::int8_conv``: schema, fake tensors
    (the output's shape and dtype, without running) and the autograd registration hold;
    on the CPU they return the plain versions (the quantization at its channel pitch)."""
    gen = torch.Generator().manual_seed(c)
    x = torch.randn(2, 5, 5, c, generator=gen)
    s_x = x.abs().amax() / 127
    q = K.quantize_activation(x, s_x)
    assert torch.equal(q, K.quantize_activation_plain(x, s_x)) and q.stride()[2] == K.channel_pitch(c)
    w = torch.randint(-127, 128, (3, 3, c, 8), dtype=torch.int8, generator=gen)
    scale, bias = torch.rand(8, generator=gen), torch.randn(8, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        got = K.int8_conv(q, w, s_x, scale, bias, 2, 1, 1, out_dtype=dtype)
        assert torch.equal(got, K.int8_conv_plain(q, w, s_x, scale, bias, 2, 1, 1, dtype)) and got.is_contiguous()
    torch.library.opcheck(torch.ops.holocron_tpu_torch.int8_quantize.default, (x, s_x))
    torch.library.opcheck(torch.ops.holocron_tpu_torch.int8_conv.default,
                          (q, w, s_x, scale, bias, [2, 2], [1, 1], [1, 1], 1, torch.bfloat16, None))


def test_export_round_trips_float_int8_and_a_detector(tmp_path):
    """A tiny RepVGG (reparametrized), its int8 form (the graph holding both ops once an
    int8 layer) and a tiny YOLOv2 with its post-processing, each exported, saved,
    loaded and run."""
    model = _tiny().reparametrize().eval()
    rec = export.export(model, _x(), tmp_path / "float.pt2")
    assert rec["max_abs_err"] <= 1e-5 and rec["custom_ops"] == {op: 0 for op in export.OPS} and rec["file_bytes"] > 0
    qm = quant.quantize_model(model, min_in_channels=8).eval()
    layers = sum(isinstance(m, quant.QuantizedConv2d) for m in qm.modules())
    rec = export.export(qm, _x(), tmp_path / "int8.pt2")
    assert layers == 3 and rec["equal"] and rec["custom_ops"] == {op: layers for op in export.OPS}
    program = torch.export.load(str(tmp_path / "int8.pt2"))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "holocron_tpu_torch.int8_conv.default" in targets and "holocron_tpu_torch.int8_quantize.default" in targets
    det = YOLOv2([(8, 0), (16, 1), (32, 1)], num_classes=3, device="cpu",
                 generator=torch.Generator().manual_seed(2)).eval()
    det.box_score_thresh = 0.0  # random heads: keep candidates for the NMS to decide on
    rec = export.export(export._DetectionExport(det), _x(32), tmp_path / "det.pt2")
    assert rec["equal"] and rec["outputs"] == [(2, 80, 4), (2, 80), (2, 80), (2, 80)]


def test_export_main_checks_the_round_trip(tmp_path):
    """``main()`` at full width (repvgg_a0, 32 px, int8): the file written, the int8 ops in
    its graph, the loaded program equal to eager; ``savedmodel`` is refused."""
    out = tmp_path / "repvgg_a0.pt2"
    rec = export.main(export.parse_args(["repvgg_a0", "--device", "cpu", "--size", "32", "--quantize",
                                         "--output", str(out)]))
    assert out.exists() and rec["equal"] and rec["custom_ops"]["holocron_tpu_torch.int8_conv"] == 26
    with pytest.raises(ValueError, match="savedmodel"):
        export.main(export.parse_args(["repvgg_a0", "--device", "cpu", "--format", "savedmodel"]))


def test_eval_latency_and_bench_zoo_run_on_the_cpu(tmp_path, capsys):
    """``eval_latency``'s protocol in bfloat16 and int8, and a ``bench_zoo`` sweep whose
    rows carry the JAX keys, a failing model written as an ``error`` row."""
    rec = eval_latency.main(eval_latency.parse_args(["mobileone_s0", "--device", "cpu", "--size", "32", "--it", "2",
                                                     "--warmup", "1", "--dtype", "bfloat16", "--batch", "2"]))
    assert rec["mean_ms"] > 0 and rec["img_per_s"] > 0 and "host mean" in capsys.readouterr().out
    rec = eval_latency.main(eval_latency.parse_args(["repvgg_a0", "--device", "cpu", "--size", "32", "--it", "1",
                                                     "--warmup", "1", "--quantize"]))
    assert rec["quantized"] and rec["mean_ms"] > 0
    out = tmp_path / "zoo.jsonl"
    rows = bench_zoo.main(bench_zoo.parse_args(["--device", "cpu", "--batch", "1", "--size", "40", "--it", "1",
                                                "--warmup", "1", "--tasks", "classification", "segmentation",
                                                "--archs", "mobileone_s0", "unet3p", "--out", str(out)]))
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows
    assert set(rows[0]) == {"arch", "task", "batch", "size", "dtype", "mean_ms", "img_per_sec", "params_m",
                            "compile_s", "form"} and rows[0]["form"] == "eager"
    assert rows[1]["arch"] == "unet3p" and "error" in rows[1]  # 40 px is not a multiple of 16


def test_clean_checkpoint_keeps_the_model(tmp_path):
    """A trainer checkpoint stripped to its model's state dict, which loads as it was;
    the printed count is the model's parameters."""
    from holocron_tpu_torch.trainer import ClassificationTrainer

    model = _tiny()
    trainer = ClassificationTrainer(model, device="cpu")
    trainer.save(str(tmp_path / "trainer.pt"))
    count = clean_checkpoint.main(clean_checkpoint.parse_args([str(tmp_path / "trainer.pt"),
                                                               str(tmp_path / "model.pth")]))
    state = torch.load(tmp_path / "model.pth", weights_only=True)
    assert count == sum(p.numel() for p in model.parameters())
    assert state.keys() == model.state_dict().keys()
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in state.items())
    np.testing.assert_equal(clean_checkpoint.main(clean_checkpoint.parse_args([str(tmp_path / "model.pth"),
                                                                               str(tmp_path / "again.pth")])), count)
