#!/usr/bin/env python
"""The int8 KxK conv's routes side by side at small and large batches, on the card:

    python holocron_tpu_torch/bench_int8_routes.py [--root DIR] [--batches 1 8 32 256]

``--root`` is a checkout whose ``holocron_tpu_torch`` is timed (default: this file's),
so that two commits can be compared on one card in one run: unpack the other with
``git archive`` and run the two alternately. Prints one JSON line a row:

- ``kind: "geometry"``: repvgg_a0's stride-1 3x3 int8 layers of the halo route (48 ->
  48 at 112 and 56 px), at each batch: ``route`` and ``conv_ms``, the conv as the tree
  routes that launch (quantized input, bf16 out), and, where the tree has the halo
  route, ``halo_ms`` and ``wgmma_ms``, each kernel forced on the same operands (their
  accumulators and bf16 outputs first checked equal, bit for bit). Device times from
  CUDA graphs of 20 calls, replayed 3 times. ``q_rows`` and
  ``pixels`` are the halo kernel's rows of the GEMM (whole 64-row chunks of each
  image's padded q space) and the output pixels: their ratio is the rows whose
  products are computed and not stored.
- ``kind: "forward"``: repvgg_a0's selective-int8 deploy form (random weights from
  seed 0, reparametrized, calibrated on a naturalistic batch, bf16 remainder), at
  each batch: ``eager_ms`` (the host's CUDA-event time of a forward called in a loop,
  ``chip_smoke.py``'s ``int8_batch8_ms`` at batch 8) and ``graph_ms`` (the captured
  forward's device time), and its int8 launches by route.

The first line names the card and its power limit. ``--rows`` prints instead, without
a card, a line for each of repvgg_a0's stride-1 3x3 map sizes (``kind: "rows"``): an
image's output pixels, the halo kernel's GEMM rows for it (``q_rows``) and their ratio.
A tile of TMA's im2col mode would run over the pixels themselves, with no such rows.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    del sys.path[0]  # run as a file: the package's own directory would shadow top-level modules

GEOMETRIES = ((48, 48, 112), (48, 48, 56))  # C, O, H = W; 3x3, stride 1, padding 1
REPVGG_A0_STRIDE1_MAPS = (112, 56, 28, 14, 7)
SEED = 0


def halo_q_rows(hw: int, k: int = 3, pad: int = 1) -> int:
    """The halo kernel's GEMM rows for one image of an ``hw`` x ``hw`` map (a KxK,
    stride-1 conv): the padded row pitch times the output rows, less the last row's
    padded columns, in whole 64-row chunks (``csrc/int8_conv.cu``'s q space)."""
    wq, out = hw + 2 * pad, hw + 2 * pad - k + 1
    return -(-((out - 1) * wq + out) // 64) * 64


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Mean device time of ``fn`` in ms, ``iters`` calls captured in one CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms from CUDA events around ``iters`` calls from the host."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def geometry_rows(batches) -> list:
    import torch

    from holocron_tpu_torch.kernels import int8_conv as K

    has_halo = hasattr(K, "halo_takes")
    rows = []
    for c, o, hw in GEOMETRIES:
        gen = torch.Generator(device="cuda").manual_seed(SEED + hw)
        w_q = torch.randint(-127, 128, (3, 3, c, o), generator=gen, device="cuda", dtype=torch.int8)
        w_scale = torch.rand(o, generator=gen, device="cuda") / 127
        bias = torch.randn(o, generator=gen, device="cuda").to(torch.bfloat16)
        packed = K.pack_weights(w_q)
        q_rows = halo_q_rows(hw)
        for n in batches:
            x = torch.randn(n, hw, hw, c, generator=gen, device="cuda").relu().to(torch.bfloat16)
            s_x = x.float().abs().amax() / 127
            x_q = K.quantize_activation(x, s_x)
            launch = {"rows": n * hw * hw} if hasattr(K, "HALO_MIN_ROWS") else {}
            route = K.conv_route(c, o, kernel_size=3, padding=1, **launch)
            args = (s_x, w_scale, bias, 1, 1, 1)
            row = {"kind": "geometry", "c": c, "o": o, "hw": hw, "batch": n, "route": route,
                   "q_rows": n * q_rows, "pixels": n * hw * hw}
            with torch.no_grad():
                row["conv_ms"] = graph_ms(lambda: K.int8_conv(x_q, w_q, *args, out_dtype=torch.bfloat16,
                                                              w_packed=packed))
                if has_halo:
                    def forced(other, out_dtype=torch.bfloat16):
                        return K._launch(x_q, w_q, packed, s_x, w_scale, bias, 1, 1, 1, out_dtype, 1, route=other)

                    for out_dtype in (torch.int32, torch.bfloat16):
                        if not torch.equal(forced("halo", out_dtype), forced("wgmma", out_dtype)):
                            raise SystemExit(f"{c} -> {o} at {hw} px, batch {n}: the halo and wgmma kernels differ")
                    row["halo_ms"] = graph_ms(lambda: forced("halo"))
                    row["wgmma_ms"] = graph_ms(lambda: forced("wgmma"))
            rows.append(row)
    return rows


def forward_rows(batches) -> list:
    import torch

    from holocron_tpu_torch import models
    from holocron_tpu_torch.bench import naturalistic_batch
    from holocron_tpu_torch.kernels import KERNELS
    from holocron_tpu_torch.quant import QuantizedConv2d, quantize_model

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = models.repvgg_a0(num_classes=10, generator=torch.Generator().manual_seed(SEED), device="cuda")
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        model.reparametrize()
    model = model.to(memory_format=torch.channels_last)
    calib = naturalistic_batch(gen, 64, 224, "cuda")
    qm = quantize_model(model, calibration_batches=[calib], arch="repvgg_a0").to(torch.bfloat16)
    routes = [m.route for m in qm.modules() if isinstance(m, QuantizedConv2d)]
    rows = []
    for n in batches:
        x = naturalistic_batch(gen, n, 224, "cuda").to(torch.bfloat16)
        with torch.no_grad():
            for k in KERNELS.values():
                k.launches = 0
            out = qm(x)
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
            if not bool(torch.isfinite(out.float()).all()) or tuple(out.shape) != (n, 10):
                raise SystemExit(f"repvgg_a0 int8 forward at batch {n}: bad output {tuple(out.shape)}")
            counts = {r: routes.count(r) for r in sorted(set(routes))}
            rows.append({"kind": "forward", "model": "repvgg_a0", "batch": n, "routes": counts, "launches": launches,
                         "eager_ms": eager_ms(lambda: qm(x)), "graph_ms": graph_ms(lambda: qm(x), iters=5)})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                        help="the checkout whose holocron_tpu_torch is timed")
    parser.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32, 256])
    parser.add_argument("--forward-batches", type=int, nargs="+", default=[8, 256])
    parser.add_argument("--rows", action="store_true", help="print the GEMM rows of each map size and exit")
    args = parser.parse_args(argv)
    if args.rows:
        for hw in REPVGG_A0_STRIDE1_MAPS:
            rows = halo_q_rows(hw)
            print(json.dumps({"kind": "rows", "hw": hw, "pixels": hw * hw, "q_rows": rows,
                              "q_rows_over_pixels": rows / (hw * hw)}))
        return 0
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip().splitlines()
    print(json.dumps({"kind": "card", "root": args.root, "card": card[0] if card else None}), flush=True)
    for row in geometry_rows(args.batches) + forward_rows(args.forward_batches):
        row["root"] = args.root
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
