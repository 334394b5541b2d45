"""Device time by operation from ``torch.profiler`` traces, the port of
``holocron_tpu/utils/profiling.py``.

A micro-benchmark reads the device's timeline, not the host's clock: the host returns
before the card has run what it queued. :func:`device_op_summary` runs a function under
``torch.profiler``, writes the chrome trace (``export_chrome_trace``) and
:func:`trace_device_ops` sums its CUDA kernel events by name. On a trace of a run on
the CPU (no kernel and no launch) the host's operators stand in, as the JAX helper
falls back to the host timeline there: each operator by its self time, so that no time
is counted twice. A trace that records launches on the card but no kernel (the
profiler's device tracing failed) raises: host time never stands in for device time.

The profiler can lose the records at a session's edges (on an H100, late in a long run,
about 175 kernel records a session), so :func:`device_op_summary` calls the function
before and after the calls it counts, inside a ``record_function`` range (``window``):
only the kernels of the launches made inside that range count, matched to them by
correlation id, and a launch in it without its kernel raises.
"""

import json
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.profiler import record_function

__all__ = ["device_op_summary", "trace_device_ops", "trace_kernels"]


def _self_times(events: List[Dict[str, Any]]) -> List[Tuple[str, float]]:
    """``(name, self µs)`` of each event: its duration less its direct children's, the
    nesting taken from the events' intervals on each thread."""
    by_thread: Dict[Any, List[Dict[str, Any]]] = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[List] = []  # [end, name, duration, children's time]
        for e in evs:
            dur = float(e.get("dur", 0.0))
            while stack and stack[-1][0] <= e["ts"]:
                _, name, d, children = stack.pop()
                out.append((name, d - children))
            if stack:
                stack[-1][3] += dur
            stack.append([e["ts"] + dur, e["name"], dur, 0.0])
        out += [(name, d - children) for _, name, d, children in stack]
    return out


def _trace_events(trace: Union[str, Path, Dict[str, Any]]) -> List[Dict[str, Any]]:
    if not isinstance(trace, dict):
        trace = json.loads(Path(trace).read_text())
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]


def _is_launch(e: Dict[str, Any]) -> bool:
    name = e.get("name", "")
    return e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in name and "HostFunc" not in name


def _in_window(events: List[Dict[str, Any]], window: Optional[str]) -> List[Dict[str, Any]]:
    """The host events that start inside a ``record_function`` range named ``window``
    (all of them where ``window`` is None)."""
    if window is None:
        return events
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == window]
    if not ranges:
        raise ValueError(f"the trace holds no range named {window!r}")
    return [e for e in events if e.get("cat") != "user_annotation" and any(a <= e["ts"] <= b for a, b in ranges)]


def _kernel_pairs(events: List[Dict[str, Any]], window: Optional[str] = None) -> List[Tuple[str, float]]:
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in _in_window(events, window) if _is_launch(e)]
    if not kernels and launches:
        raise ValueError("the trace records kernel launches on the card but no kernel: the profiler's device "
                         "tracing failed, and the host's times are no device time")
    if window is not None:
        ids = {e.get("args", {}).get("correlation") for e in launches}
        kernels = [e for e in kernels if e.get("args", {}).get("correlation") in ids]
        lost = ids - {e["args"]["correlation"] for e in kernels}
        if lost:
            raise ValueError(f"the profiler lost the kernels of {len(lost)} of the {len(ids)} launches in {window!r}")
    return [(e["name"], float(e.get("dur", 0.0))) for e in kernels]


def trace_kernels(trace: Union[str, Path, Dict[str, Any]], window: Optional[str] = None) -> List[Tuple[str, float]]:
    """``(kernel name, µs)`` of each of a chrome trace's device kernel events (``"cat":
    "kernel"``, a CUDA graph's replayed kernels included), in the trace's order; with
    ``window``, only those of the launches made inside the ``record_function`` ranges of
    that name. Raises ``ValueError`` where the trace records launches (``cudaLaunchKernel``,
    ``cudaGraphLaunch``) but no kernel, or a launch in ``window`` has none."""
    return _kernel_pairs(_trace_events(trace), window)


def trace_device_ops(trace: Union[str, Path, Dict[str, Any]], window: Optional[str] = None) -> Dict[str, float]:
    """``{kernel name: total µs}`` over the device's kernel events (``"cat": "kernel"``)
    of a chrome trace (its path or its parsed JSON), host events ignored; a trace of a
    run on the CPU (no kernel event and no launch) gives its host operators (``"cat":
    "cpu_op"``) instead, each by its self time (its duration less its children's).
    ``window`` and the errors as :func:`trace_kernels`."""
    return _op_times(_trace_events(trace), window)


def _op_times(events: List[Dict[str, Any]], window: Optional[str] = None) -> Dict[str, float]:
    pairs = _kernel_pairs(events, window) or _self_times(
        [e for e in _in_window(events, window) if e.get("cat") == "cpu_op"])
    agg: Dict[str, float] = defaultdict(float)
    for name, us in pairs:
        agg[name] += us
    return dict(agg)


WINDOW = "holocron_profiled"  # the record_function range whose calls device_op_summary counts


def device_op_summary(fn: Callable, *args: Any, iters: int = 20, logdir: Optional[str] = None,
                      pad: int = 3) -> Dict[str, Any]:
    """Runs ``fn(*args)`` once outside the trace, then under ``torch.profiler`` (the
    card's activity included where a CUDA device is) ``pad`` times, ``iters`` times
    inside a ``record_function`` range (:data:`WINDOW`) and ``pad`` times more, and
    returns ``{"ms_per_iter", "ops"}``: the summed operation time of a counted call in
    ms and :func:`trace_device_ops` of the range, from the trace kept in ``logdir`` (a
    temporary directory by default) as ``trace.json``. ``wall_ms_per_iter`` is the
    host's time a counted call, for the idle share. Raises ``RuntimeError`` where an
    argument lies on the card and the range holds no kernel, and ``ValueError`` where
    the profiler lost a kernel launched in the range."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    with torch.no_grad():
        fn(*args)
        sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            for _ in range(pad):
                fn(*args)
            sync()
            t0 = time.perf_counter()
            with record_function(WINDOW):
                for _ in range(iters):
                    fn(*args)
                sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            for _ in range(pad):
                fn(*args)
            sync()
    path = Path(logdir or tempfile.mkdtemp(prefix="holocron_ops_")) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = _trace_events(path)
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args) and not _kernel_pairs(events, WINDOW):
        raise RuntimeError(f"device_op_summary: {fn!r} ran on the card but its trace holds no kernel")
    ops = _op_times(events, WINDOW)
    return {"ms_per_iter": sum(ops.values()) / iters / 1e3, "wall_ms_per_iter": wall_ms, "ops": ops}
