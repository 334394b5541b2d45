"""GPipe's memory claim on the card: the port of ``scripts/bench_pipeline_memory.py``.

:mod:`~holocron_tpu_torch.parallel.pipeline` claims that a process holds ``2·B/n + B/M``
of activations (its two belt shards and one circulating microbatch) instead of the
batch ``B``. This runs darknet53's 512-channel stage (``features.layers.3``: eight
``ResBlock(512, 256)``, random weights from seed 0, batch norm statistics drawn away
from the identity; float32, TF32 off) on a stage input of ``--batch`` images at
``--hw`` x ``--hw`` (16: the stage behind a 256 px image), under ``no_grad``, both as
the sequential fold of the blocks on each process and pipelined over the processes of
the group at ``M`` = 8 and 16 microbatches (:data:`MICROBATCHES`). Each reading is
taken above what was allocated when the call began (the stacked weights and the
input), in bytes and in units of one whole-batch activation buffer
(``B·512·hw·hw·4`` bytes), beside the theory's ``2/n + 1/M``:

- ``peak``: the peak device memory (``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats``);
- ``held``: the most allocated when a block call began, which is what the schedule
  holds (belts, the microbatch in flight) apart from the block's own temporaries;
- ``block_temporaries``: the peak of one block called on one microbatch ``B/M``;
- ``workspace``: of those, the most one of its convolutions takes beyond its output,
  which is cuDNN's workspace (also read for the fold's blocks at ``B``).

A pipelined run passes when its ``held`` is within ``1.5 ×`` the theory's buffers, and
its peak is below the fold's and within ``1.5 ×`` the theory's buffers plus one block's
temporaries. Each process prints one JSON line.

    python -m holocron_tpu_torch.bench_pipeline_memory [--batch 256] [--hw 16]
    torchrun --nproc_per_node 2 -m holocron_tpu_torch.bench_pipeline_memory

Without ``torchrun`` it spawns two processes itself. Processes that share a
card (two on one H100) join over gloo, whose point-to-point sends go through host
memory (``collectives.STAGED_BYTES``, printed); one card a process joins over NCCL.
Wall times are printed too, and are no speed claim under gloo.
"""

import argparse
import json
import os
import socket
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import distributed as dist
from torch import nn
from torch.func import functional_call

from .models.core import cudnn_settings
from .parallel import collectives, create_mesh, pipeline_module, stage_variables

__all__ = ["conv_workspace", "darknet53_stage", "fold", "measure"]

STAGE = "features.layers.3"  # darknet53's 512-channel stage: children 3 to 10, its ResBlocks
CHANNELS = 512
MICROBATCHES = (8, 16)
SPAWNED = 2  # processes spawned without torchrun


def darknet53_stage(device, seed: int = 0) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """One ``ResBlock(512, 256)`` in eval mode on ``device`` and the stacked variables of
    darknet53's stage 3 there: the weights of ``darknet53`` drawn from ``seed``, each
    batch norm's scale and variance then drawn from U(0.5, 1.5), its bias and mean from
    N(0, 0.1)."""
    from .models.classification.darknetv3 import ResBlock, darknet53

    model = darknet53(generator=torch.Generator().manual_seed(seed), device="cpu")
    stacked = stage_variables(model, STAGE)
    block = ResBlock(CHANNELS, CHANNELS // 2)
    gen = torch.Generator().manual_seed(seed + 1)
    for name, m in block.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            for key, draw in (("weight", "uniform"), ("bias", "normal"), ("running_mean", "normal"),
                              ("running_var", "uniform")):
                t = stacked[f"{name}.{key}"]
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5 if draw == "uniform"
                        else 0.1 * torch.randn(t.shape, generator=gen))
    return block.to(device).eval(), {k: v.to(device) for k, v in stacked.items()}


def fold(block: nn.Module, stacked: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The blocks applied in sequence on this process (``block`` in eval mode): the
    pipeline's reference."""
    for i in range(next(iter(stacked.values())).shape[0]):
        x = functional_call(block, {k: v[i] for k, v in stacked.items()}, (x,))
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_above(fn: Callable[[], torch.Tensor], device: torch.device,
               block: Optional[nn.Module] = None) -> Tuple[torch.Tensor, Optional[int], float, Optional[int]]:
    """``fn()``, its peak device memory in bytes above what was allocated when it began,
    its wall ms, and the most allocated above that same mark when a call of ``block``
    began (what ``fn`` held while it ran a block, apart from the block's own temporaries
    and cuDNN's workspace). The memory readings are None off the card (not measured), and
    the last one without ``block``."""
    _sync(device)
    cuda = device.type == "cuda"
    held = []
    if cuda:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    hook = block.register_forward_pre_hook(lambda m, a: held.append(torch.cuda.memory_allocated(device))) \
        if cuda and block is not None else None
    try:
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        if hook is not None:
            hook.remove()
    if not cuda:
        return out, None, ms, None
    return out, torch.cuda.max_memory_allocated(device) - base, ms, (max(held) - base if held else None)


def conv_workspace(block: nn.Module, variables: Dict[str, torch.Tensor], x: torch.Tensor) -> Optional[int]:
    """The most device memory that one convolution of ``block``, applied with
    ``variables`` to ``x``, takes beyond its output while it runs: cuDNN's workspace for
    the algorithm its heuristics pick at that shape (None off the card)."""
    device = x.device
    if device.type != "cuda":
        return None
    seen = []

    def before(m, args):
        torch.cuda.reset_peak_memory_stats(device)
        seen.append(torch.cuda.memory_allocated(device))

    def after(m, args, out):
        seen[-1] = torch.cuda.max_memory_allocated(device) - seen[-1] - out.numel() * out.element_size()

    hooks = [h for c in block.modules() if isinstance(c, nn.Conv2d)
             for h in (c.register_forward_pre_hook(before), c.register_forward_hook(after))]
    try:
        functional_call(block, variables, (x,))
    finally:
        for h in hooks:
            h.remove()
    return max(seen)


def measure(block: nn.Module, stacked: Dict[str, torch.Tensor], x: torch.Tensor, mesh, axis: str = "pipe") -> dict:
    """This process's readings (see the module docstring) of the fold and of the
    pipeline over ``mesh``'s ``axis`` at each of :data:`MICROBATCHES`, under ``no_grad``
    with cuDNN's heuristics picking the algorithms (``benchmark`` off, so the block at a
    microbatch's shape takes the same one in its own reading and in the pipeline). A
    collective: every process of the axis calls it in lockstep."""
    device = x.device
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    buf = x.numel() * x.element_size()
    rec = {"batch": x.shape[0], "hw": x.shape[-1], "channels": x.shape[1],
           "blocks": next(iter(stacked.values())).shape[0], "stages": n, "buffer_bytes": buf,
           "params_bytes": sum(v.numel() * v.element_size() for v in stacked.values())}
    first = {k: v[0] for k, v in stacked.items()}
    with torch.no_grad(), cudnn_settings(benchmark=False):
        fold(block, stacked, x)  # warm-up: cuDNN's first call at a shape sets it up
        _, peak, ms, held = peak_above(lambda: fold(block, stacked, x), device, block)
        rec["fold"] = {"peak_bytes": peak, "buffers": None if peak is None else peak / buf, "wall_ms": ms,
                       "held_bytes": held, "workspace_bytes": conv_workspace(block, first, x)}
        rec["pipelined"] = []
        for m in MICROBATCHES:
            mb = x[: x.shape[0] // m]
            functional_call(block, first, (mb,))
            _, temps, _, _ = peak_above(lambda: functional_call(block, first, (mb,)), device)
            staged = collectives.STAGED_BYTES[0]
            _, peak, ms, held = peak_above(
                lambda: pipeline_module(block, stacked, x, mesh, axis, num_microbatches=m), device, block)
            theory = 2 / n + 1 / m
            run = {"microbatches": m, "peak_bytes": peak, "theory_buffers": theory, "held_bytes": held,
                   "block_temporaries_bytes": temps, "workspace_bytes": conv_workspace(block, first, mb),
                   "wall_ms": ms, "staged_bytes": collectives.STAGED_BYTES[0] - staged}
            if peak is not None:
                run["buffers"] = peak / buf
                run["held_buffers"] = held / buf
                run["held_within_theory"] = held <= 1.5 * theory * buf
                run["limit_bytes"] = 1.5 * theory * buf + temps
                run["within_limit"] = peak <= run["limit_bytes"]
                run["below_fold"] = peak < rec["fold"]["peak_bytes"]
            rec["pipelined"].append(run)
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="GPipe's per-process memory on darknet53's 512-channel stage")
    parser.add_argument("--batch", default=256, type=int)
    parser.add_argument("--hw", default=16, type=int, help="the stage input's height and width (16: 256 px images)")
    parser.add_argument("--device", default="cuda", help="cuda, or cpu to rehearse (no memory readings)")
    return parser.parse_args(argv)


def run(args: argparse.Namespace, rank: int, world: int, init_method: str = "env://") -> dict:
    """One process: joins the group (gloo where processes share a card or on the CPU,
    NCCL with a card each), measures and prints its JSON line."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    shared = True
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        shared = torch.cuda.device_count() < int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "gloo" if shared else "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **({} if shared else {"device_id": device}))
    try:
        block, stacked = darknet53_stage(device)
        gen = torch.Generator(device=device).manual_seed(2)
        x = torch.randn(args.batch, CHANNELS, args.hw, args.hw, generator=gen, device=device)
        rec = measure(block, stacked, x, create_mesh(axes=("pipe",), device_type=device.type))
        rec.update(rank=rank, world=world, backend=backend,
                   device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
        print(json.dumps(rec), flush=True)
        return rec
    finally:
        dist.destroy_process_group()


def _spawned(rank: int, args: argparse.Namespace, port: int) -> None:
    run(args, rank, SPAWNED, f"tcp://127.0.0.1:{port}")


def main(argv=None) -> None:
    args = parse_args(argv)
    if "WORLD_SIZE" in os.environ:  # under torchrun
        run(args, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]))
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.start_processes(_spawned, args=(args, port), nprocs=SPAWNED, start_method="spawn")


if __name__ == "__main__":
    main()
