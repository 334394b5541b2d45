"""End-to-end HTTP serving latency of the port's service (``scripts/bench_serving.py``).

Starts the stdlib service (:mod:`.api.main`) in this process and sends warm
``POST /classification`` requests carrying the repository's JPEG
``tests/assets/quicktour_golf_ball.jpg`` (384 x 384), then prints one JSON line a row:

- sequential (default): one request in flight; median and p90 end-to-end latency and
  the server's per-stage attribution (decode, queue wait, device call);
- ``--concurrency 1 4 16 64``: a closed loop, k client threads each keeping one
  request in flight, ``--n / k`` timed requests each and never fewer than
  :data:`MIN_PER_CLIENT` (so that no row is a single burst); req/s, p50/p90/p99
  end-to-end latency, and the mean device batch from the ``X-Batch-Size`` header (the
  evidence that batch-while-busy coalesces).

    python -m holocron_tpu_torch.bench_serving --arch rexnet1_0x --concurrency 1 4 16 64 --n 100 [--quantize force]

The model runs where ``HOLOCRON_DEVICE`` says (the card by default).
"""

import argparse
import http.client
import json
import socket
import statistics
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["ASSET", "MIN_PER_CLIENT", "closed_loop", "per_client", "post", "sequential"]

ASSET = Path(__file__).resolve().parents[1] / "tests" / "assets" / "quicktour_golf_ball.jpg"
MIN_PER_CLIENT = 8  # timed requests a client in a closed loop, at the least


def _connect(port: int, timeout: float) -> http.client.HTTPConnection:
    """A keep-alive connection with TCP_NODELAY: http.client sends headers and body in
    separate writes, and Nagle with delayed ACKs stalls a reused connection ~40 ms."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


def post(conn: http.client.HTTPConnection, payload: bytes) -> Tuple[float, Dict[str, float]]:
    """One classification request: its end-to-end ms and the server's stage headers.
    Raises unless the answer is 200."""
    t0 = time.perf_counter()
    conn.request("POST", "/classification", body=payload, headers={"Content-Type": "image/jpeg"})
    resp = conn.getresponse()
    body = resp.read()
    dt = (time.perf_counter() - t0) * 1e3
    if resp.status != 200:
        raise RuntimeError(f"POST /classification answered {resp.status}: {body[:200]!r}")
    stages = {
        "server": float(resp.getheader("X-Process-Time") or 0) * 1e3,
        "decode": float(resp.getheader("X-Decode-Ms") or 0),
        "queue": float(resp.getheader("X-Queue-Ms") or 0),
        "infer": float(resp.getheader("X-Infer-Ms") or 0),
        "batch": float(resp.getheader("X-Batch-Size") or 1),
    }
    return dt, stages


def _percentile(sorted_ms: List[float], q: float) -> float:
    return sorted_ms[min(int(q * len(sorted_ms)), len(sorted_ms) - 1)]


def per_client(total: int, k: int) -> int:
    """The timed requests each of k clients sends for about ``total`` in all."""
    return max(MIN_PER_CLIENT, total // k)


def closed_loop(port: int, payload: bytes, k: int, per: int) -> Dict:
    """k client threads, each with exactly one request in flight: each sends one
    untimed request (its connection and the server's handler thread then exist), and
    once all have, ``per`` timed requests. A client whose keep-alive socket the server
    closed reconnects and retries once; any other failure raises."""
    samples: list = []
    errors: list = []
    lock = threading.Lock()
    barrier = threading.Barrier(k + 1)

    def client():
        local = []
        try:
            conn = _connect(port, 600)
            post(conn, payload)
            barrier.wait()
            for _ in range(per):
                try:
                    local.append(post(conn, payload))
                except (http.client.HTTPException, ConnectionError):
                    conn.close()
                    conn = _connect(port, 600)
                    local.append(post(conn, payload))
            conn.close()
        except Exception as e:  # reported to the caller below
            errors.append(e)
            barrier.abort()  # no client, nor the caller, waits for this one
        with lock:
            samples.extend(local)

    threads = [threading.Thread(target=client) for _ in range(k)]
    for t in threads:
        t.start()
    try:
        barrier.wait()
    except threading.BrokenBarrierError:
        pass  # a client failed to connect: reported below
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} of {k} clients failed; the first: {errors[0]!r}")
    e2e = sorted(dt for dt, _ in samples)
    n = len(e2e)
    return {
        "concurrency": k,
        "n": n,
        "throughput_rps": n / wall,
        "e2e_ms_p50": _percentile(e2e, 0.5),
        "e2e_ms_p90": _percentile(e2e, 0.9),
        "e2e_ms_p99": _percentile(e2e, 0.99),
        "mean_batch_size": statistics.mean(s["batch"] for _, s in samples),
        "queue_ms_p50": statistics.median(s["queue"] for _, s in samples),
        "infer_ms_p50": statistics.median(s["infer"] for _, s in samples),
    }


def sequential(port: int, payload: bytes, n: int) -> Dict:
    """n requests one after another on one connection."""
    conn = _connect(port, 600)
    try:
        samples = [post(conn, payload) for _ in range(n)]
    finally:
        conn.close()
    e2e = sorted(dt for dt, _ in samples)
    result = {"n": n, "e2e_ms_p50": statistics.median(e2e), "e2e_ms_p90": _percentile(e2e, 0.9)}
    for stage in ("server", "decode", "queue", "infer"):
        result[f"{stage}_ms_p50"] = statistics.median(s[stage] for _, s in samples)
    # the unattributed remainder: HTTP parse, response, thread hand-off
    result["other_host_ms_p50"] = max(
        result["server_ms_p50"] - result["decode_ms_p50"] - result["queue_ms_p50"] - result["infer_ms_p50"], 0.0)
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="End-to-end HTTP serving latency of holocron_tpu_torch's service.")
    p.add_argument("--arch", default="rexnet1_0x")
    p.add_argument("--n", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--quantize", choices=["0", "1", "force"], default="0", help="as HOLOCRON_QUANTIZE")
    p.add_argument("--concurrency", type=int, nargs="*", default=[],
                   help="closed-loop mode: one row per k (k threads, 1 in-flight request each)")
    args = p.parse_args(argv)

    from .api import config, main as api_main, vision

    config.ARCH = args.arch
    config.QUANTIZE = "force" if args.quantize == "force" else args.quantize == "1"
    payload = ASSET.read_bytes()
    vision.get_batcher()  # load the model and capture every bucket before the clock runs
    srv = api_main.serve("127.0.0.1", 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        if args.warmup:
            sequential(port, payload, args.warmup)
        rows = ([closed_loop(port, payload, k, per_client(args.n, k)) for k in args.concurrency] if args.concurrency
                else [sequential(port, payload, args.n)])
        for row in rows:
            print(json.dumps({**row, "arch": args.arch, "quantize": args.quantize}), flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        vision.reset()


if __name__ == "__main__":
    main()
