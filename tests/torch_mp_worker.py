"""Multi-process worker for the port's parallelism tests (``tests/test_torch_parallel*.py``,
``tests/test_torch_{tensor,spatial}_parallel.py``).

Launched as N OS processes joined by ``torch.distributed`` over gloo on the CPU, one
process a "device", as ``torchrun`` launches the port; imports no JAX. The tests also
import it to run the one-process reference in their own process.

    python tests/torch_mp_worker.py <mode> <rank> <world> <port> <outdir> [variant]

Modes:

- ``train``: the port's ``ClassificationTrainer`` on ``RepVGG([1], [8], 1.0, 1.0,
  num_classes=5)`` over index-keyed data, a global batch of 8 (8 / world a process,
  ``EpochDataLoader(num_shards="auto")``), 2 epochs, then ``evaluate()`` and a
  checkpoint; ``variant`` ``zero1`` adds ``shard_opt_state``, ``tp`` ``model_parallel=2``
  (channels of 4 or more split, ``tp_min_channels=4``) and ``spatial``
  ``spatial_parallel=2``, both over a data axis of ``world / 2`` (a global batch of 8
  still). Rank 0 writes the parameters and BN statistics (whole, from the checkpoint),
  the metrics and each rank's optimizer-state elements.
- ``det``: ``DetectionTrainer.evaluate`` over a sharded loader with a deterministic
  stub detector; every rank writes its metrics.
- ``tp`` / ``sp``: tensor and spatial parallelism's inference (and the spatial train
  step) on models a test saved in ``<outdir>/inputs.pt``; every rank writes its
  outputs and the one-process ones (``tests/test_torch_{tensor,spatial}_parallel.py``).
- ``amp``: the first train step of the ``tp`` and ``spatial`` variants under ``amp``
  (bf16 compute); rank 0 writes the loss and the reduced gradients, whole.
- ``pipeline``: GPipe (``parallel.pipeline_blocks`` / ``pipeline_module``) on the cases
  a test saved in ``<outdir>/pipeline_inputs.pt`` over a ``("pipe",)`` mesh of every
  process: each rank writes its output rows, the gathered output, its gradients and the
  errors of bad arguments (``tests/test_torch_pipeline.py``).
- ``elastic``: checkpoints across layouts (``tests/test_torch_elastic_restore.py``);
  ``variant`` ``save`` (2 processes) trains ``tp`` and ``zero1`` trainers 4 steps and
  saves them (a file, and for ``tp`` a directory too), restores the ZeRO-1 file into a
  ``tp`` trainer and continues 4 steps; ``restore`` (4 processes) restores the ``tp``
  file and directory into ``model_parallel=4`` trainers and continues. Both save or
  load a model with a tensor split in blocks of unequal length. Rank 0 writes the
  records.
- ``collectives``: ``parallel.initialize()`` from the environment (twice), the mesh, the
  named collectives and their gradients, ``host_local_put`` / ``shard_batch`` /
  ``replicate_to_host``, the cross-process batch norm against ``nn.BatchNorm2d`` on
  the whole batch, and the trainer's gradient all-reduce on known per-rank gradients of
  two dtypes over several buckets; each rank writes what it saw.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GLOBAL_BATCH = 8
TRAIN_SAMPLES, VAL_SAMPLES = 32, 16


class IndexedDataset:
    """Samples keyed by index only, the same on every process: a CHW float32 image and
    a label."""

    def __init__(self, n: int, seed: int = 0) -> None:
        self.n, self.seed = n, seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        r = np.random.default_rng(1000 * (self.seed + 1) + i)
        return torch.from_numpy(r.normal(size=(3, 16, 16)).astype(np.float32)), i % 5


VARIANTS = {"plain": {}, "zero1": {"shard_opt_state": True}, "tp": {"model_parallel": 2, "tp_min_channels": 4},
            "tp4": {"model_parallel": 4, "tp_min_channels": 4}, "spatial": {"spatial_parallel": 2}}


def make_trainer(world: int, variant: str = "plain", output_file: str = "ckpt.pt", amp: bool = False):
    """The trainer every rank of a ``world``-process run builds (``world`` 1: the
    one-process run, no process group), with bf16 compute under ``amp``."""
    from holocron_tpu_torch.models import RepVGG
    from holocron_tpu_torch.nn.functional import cross_entropy
    from holocron_tpu_torch.optim import SGD
    from holocron_tpu_torch.trainer import ClassificationTrainer
    from holocron_tpu_torch.utils.data import EpochDataLoader

    extra = VARIANTS[variant]
    local_bs = GLOBAL_BATCH // (world // max(extra.get("model_parallel", 1), extra.get("spatial_parallel", 1)))
    train_loader = EpochDataLoader(IndexedDataset(TRAIN_SAMPLES), local_bs, shuffle=True, seed=0, num_shards="auto")
    val_loader = EpochDataLoader(IndexedDataset(VAL_SAMPLES, seed=7), local_bs, num_shards="auto")
    model = RepVGG([1], [8], 1.0, 1.0, num_classes=5, device="cpu", generator=torch.Generator().manual_seed(0))
    # SGD's step is proportional to the gradient, so a sum where the mean belongs shows
    return ClassificationTrainer(model, train_loader, val_loader, cross_entropy,
                                 lambda groups, lr: SGD(groups, lr, momentum=0.9), device="cpu",
                                 output_file=output_file, amp=amp, **extra)


def state_arrays(model) -> dict:
    """Parameters and BN running statistics, copied to numpy."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items() if v.is_floating_point()}


def train(outdir: Path, world: int, variant: str = "plain") -> dict:
    trainer = make_trainer(world, variant, str(outdir / "unused.pt"))
    trainer.fit_n_epochs(2, lr=1e-3)
    metrics = trainer.evaluate()
    opt_elems = sum(t.numel() for s in trainer._opt.state.values() for t in s.values()
                    if isinstance(t, torch.Tensor) and t.ndim > 0) if trainer._opt is not None else 0
    elems = [opt_elems]
    if trainer.distributed:
        from torch import distributed as dist

        gathered = [None] * world
        dist.all_gather_object(gathered, opt_elems)
        elems = gathered
    ckpt = outdir / "trainer.pt"
    trainer.save(str(ckpt))  # every rank, in lockstep; rank 0 writes whole tensors
    state = state_arrays(trainer.model)
    if trainer.rank == 0:
        saved = torch.load(ckpt, weights_only=True)["model"]
        split = trainer._named_splits()
        for k, v in state.items():
            if k in split:  # this rank's block of the whole tensor
                lo, hi = split[k].bounds()
                np.testing.assert_array_equal(saved[k].narrow(split[k].dim, lo, hi - lo).numpy(), v)
            else:
                np.testing.assert_array_equal(saved[k].numpy(), v)
        state = {k: v.numpy() for k, v in saved.items() if v.is_floating_point()}
        np.savez(outdir / "state.npz", **state)
        (outdir / "metrics.json").write_text(json.dumps({**metrics, "opt_state_elements": elems,
                                                         "steps": trainer.step}))
    return {"state": state, "metrics": metrics, "trainer": trainer}


def amp_first_step(world: int, variant: str = "plain") -> dict:
    """The first train step under ``amp`` (bf16 compute): its loss and the gradients
    the update takes (after the reduction over the processes), whole, as numpy."""
    from holocron_tpu_torch.parallel import sharded

    trainer = make_trainer(world, variant, amp=True)
    trainer._reset_opt(1e-3)
    grads = {}
    apply = trainer._apply_update

    def capture(names, params, gs):
        grads.update({n: sharded.gather(g).detach().float().numpy().copy() for n, g in zip(names, gs)})
        return apply(names, params, gs)

    trainer._apply_update = capture
    loss = trainer._run_step(*next(iter(trainer.train_loader)))
    return {"loss": loss, "grads": grads}


def amp_steps(outdir: Path, rank: int, world: int) -> None:
    """``amp``: :func:`amp_first_step` with ``model_parallel=2`` and with
    ``spatial_parallel=2``; rank 0 writes both."""
    res = {v: amp_first_step(world, v) for v in ("tp", "spatial")}
    if rank == 0:
        torch.save(res, outdir / "amp.pt")


class StubDetector(torch.nn.Module):
    """``model(x)`` in eval mode: one detection an image, keyed off the image's fill
    value; even samples hit their box, odd ones miss it (IoU < 0.5)."""

    def __init__(self, n: int) -> None:
        super().__init__()
        self.n = n
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        out = []
        for img in x:
            i = int(round(float(img[0, 0, 0]) * self.n))
            off = 1.0 if i % 2 == 0 else 10.0
            boxes = np.array([[off + i, off + i, off + 5.0 + i, off + 5.0 + i]], np.float32)
            out.append({"boxes": boxes, "labels": np.array([i % 3]), "scores": np.ones(1)})
        return out


class DetValDataset:
    """Index-keyed images and boxes: which samples are counted shows in the error rates."""

    def __init__(self, n: int = 12) -> None:
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        box = np.array([[1.0 + i, 1.0 + i, 6.0 + i, 6.0 + i]], np.float32)
        return torch.full((3, 16, 16), i / self.n), {"boxes": box, "labels": np.array([i % 3])}


def detection(outdir: Path, rank: int) -> dict:
    from holocron_tpu_torch.trainer import DetectionTrainer
    from holocron_tpu_torch.utils.data import EpochDataLoader, default_collate

    loader = EpochDataLoader(DetValDataset(12), 4, collate_fn=default_collate, num_shards="auto")
    trainer = DetectionTrainer(StubDetector(12), None, loader, device="cpu")
    metrics = trainer.evaluate()
    (outdir / f"det_{rank}.json").write_text(json.dumps(metrics))
    return metrics


def collectives(outdir: Path, rank: int, world: int) -> None:
    from torch import distributed as dist
    from torch import nn

    from holocron_tpu_torch import parallel
    from holocron_tpu_torch.parallel import collectives as C

    parallel.initialize("cpu")
    group = dist.group.WORLD
    parallel.initialize("cpu")  # idempotent: the same group
    out = {"world": dist.get_world_size(), "rank": dist.get_rank(), "backend": dist.get_backend(),
           "same_group": dist.group.WORLD is group, "num_slices": parallel.num_slices()}
    mesh = parallel.create_mesh()
    out["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
    out["axis"] = [C.axis_index("data", mesh), C.axis_size("data", mesh), C.axis_index("model", mesh),
                   C.axis_size("model", mesh)]
    x = torch.arange(4, dtype=torch.float32).reshape(2, 2) + 10 * rank
    xr = x.clone().requires_grad_()
    total = C.psum(xr, "data", mesh)
    (total * (rank + 1)).sum().backward()
    out["psum"], out["psum_grad"] = total.tolist(), xr.grad.tolist()
    out["pmean"] = C.pmean(x).tolist()
    xr = x.clone().requires_grad_()
    gathered = C.all_gather(xr, axis=1)
    (gathered * torch.arange(gathered.numel()).reshape(gathered.shape)).sum().backward()
    out["all_gather"], out["all_gather_grad"] = gathered.tolist(), xr.grad.tolist()
    out["all_gather_stacked"] = list(C.all_gather(x, tiled=False).shape)
    xr = x.clone().requires_grad_()
    scattered = C.reduce_scatter(xr)
    (scattered * (rank + 1)).sum().backward()
    out["reduce_scatter"], out["reduce_scatter_grad"] = scattered.tolist(), xr.grad.tolist()
    xr = x.clone().requires_grad_()
    moved = C.ppermute(xr, [(i, (i + 1) % world) for i in range(world)])
    (moved * (rank + 1)).sum().backward()
    out["ppermute"], out["ppermute_grad"] = moved.tolist(), xr.grad.tolist()
    out["ppermute_partial"] = C.ppermute(x, [(0, 1)]).tolist()
    # a batch placed as each process's rows of one global tensor, and gathered back
    sharding = parallel.batch_sharding(mesh)
    local = torch.full((2, 3), float(rank))
    out["host_local_put"] = parallel.replicate_to_host(parallel.host_local_put(local, sharding)).tolist()
    glob = torch.arange(world * 2 * 3, dtype=torch.float32).reshape(world * 2, 3)
    sharded = parallel.shard_batch({"x": glob}, mesh)["x"]
    out["shard_batch_local"] = sharded.to_local().tolist()
    out["shard_batch_whole"] = parallel.replicate_to_host(sharded).tolist()
    try:
        parallel.create_mesh(model_parallel=3)
    except ValueError as err:
        out["mp3_error"] = str(err)
    # one device a process: the batch splits over the data axis however small it is
    out["data_axis_sharding"] = [str(p) for p in
                                 parallel.batch_sharding(parallel.create_mesh(model_parallel=world)).placements]
    # the cross-process batch norm against nn.BatchNorm2d on the whole batch
    gen = torch.Generator().manual_seed(5)
    whole = torch.randn(2 * world, 4, 5, 3, generator=gen) * 3 + 1
    weight = torch.rand(4, generator=gen) + 0.5
    ref_bn, bn = nn.BatchNorm2d(4), nn.BatchNorm2d(4)
    for m in (ref_bn, bn):
        with torch.no_grad():
            m.weight.copy_(weight)
    bn = parallel.convert_batchnorm(nn.Sequential(bn))[0]
    out["converted"] = type(bn).__name__
    xw = whole.clone().requires_grad_()
    y_ref = ref_bn(xw)
    (y_ref * torch.arange(y_ref.numel()).reshape(y_ref.shape).sin()).sum().backward()
    xl = whole[2 * rank : 2 * rank + 2].clone().requires_grad_()
    y = bn(xl)
    (y * torch.arange(y_ref.numel()).reshape(y_ref.shape).sin()[2 * rank : 2 * rank + 2]).sum().backward()
    grads = [p.grad for p in bn.parameters()]
    for g in grads:
        dist.all_reduce(g)
    out["bn_errors"] = {
        "y": float((y - y_ref[2 * rank : 2 * rank + 2]).abs().max()),
        "dx": float((xl.grad - xw.grad[2 * rank : 2 * rank + 2]).abs().max()),
        "dweight": float((grads[0] - ref_bn.weight.grad).abs().max()),
        "dbias": float((grads[1] - ref_bn.bias.grad).abs().max()),
        "running_mean": float((bn.running_mean - ref_bn.running_mean).abs().max()),
        "running_var": float((bn.running_var - ref_bn.running_var).abs().max()),
    }
    bn.eval()
    ref_bn.eval()
    out["bn_errors"]["eval"] = float((bn(whole) - ref_bn(whole)).abs().max())
    # the trainer's gradient average: known gradients a rank, buckets of 64 bytes
    from holocron_tpu_torch.trainer import Trainer
    from holocron_tpu_torch.trainer import core as trainer_core

    trainer = Trainer(nn.Linear(2, 2), device="cpu")
    shapes = [((3, 5), torch.float32), ((4,), torch.float64), ((7,), torch.float32), ((2, 2), torch.float64)]
    bases = [torch.arange(torch.Size(shape).numel(), dtype=dtype).reshape(shape) for shape, dtype in shapes]
    grads = [b * (rank + 1) + rank for b in bases]
    bucket_bytes, trainer_core.BUCKET_BYTES = trainer_core.BUCKET_BYTES, 64
    try:
        trainer._all_reduce_grads(grads)
    finally:
        trainer_core.BUCKET_BYTES = bucket_bytes
    mean = [sum(b * (r + 1) + r for r in range(world)) / world for b in bases]
    out["all_reduce_grads_equal_mean"] = all(g.dtype == m.dtype and torch.equal(g, m) for g, m in zip(grads, mean))
    (outdir / f"collectives_{rank}.json").write_text(json.dumps(out))


def _models(inputs: dict) -> dict:
    """The models a test saved (``inputs.pt``: state dicts converted from the JAX
    package's), in eval mode on the CPU."""
    from holocron_tpu_torch.models import RepVGG
    from holocron_tpu_torch.models.classification.convnext import ConvNeXt
    from holocron_tpu_torch.models.segmentation import UNet

    build = {"repvgg": lambda: RepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8, device="cpu"),
             "repvgg_deploy": lambda: RepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8, device="cpu").reparametrize(),
             "repvgg64": lambda: RepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8, device="cpu"),
             "repvgg67": lambda: RepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8, device="cpu"),
             "convnext": lambda: ConvNeXt([1, 1], [16, 32], num_classes=8, device="cpu"),
             "unet": lambda: UNet([8, 16], num_classes=4, device="cpu")}
    out = {}
    for name, sd in inputs["models"].items():
        model = build[name]()
        model.load_state_dict(sd)
        out[name] = model.eval()
    return out


def tensor_parallel(outdir: Path, rank: int, world: int) -> None:
    """``tp``: ``shard_inference`` over a ``("data", "model")`` mesh of one data row
    (2 processes) or two (4: DP x TP), each model's one-process forward beside it; the
    int8 form; the gathers' gradients (2 processes)."""
    from torch import distributed as dist

    from holocron_tpu_torch import parallel
    from holocron_tpu_torch.parallel import collectives as C
    from holocron_tpu_torch.quant import quantize_model

    inputs = torch.load(outdir / "inputs.pt", weights_only=False)
    models = _models(inputs)
    x = inputs["x"]
    mesh = parallel.create_mesh(("data", "model"), model_parallel=2)
    res = {}
    with torch.no_grad():
        for name in ("repvgg", "repvgg_deploy", "convnext"):
            min_ch = 16 if name == "convnext" else 8
            run = parallel.shard_inference(models[name], mesh, tensor_parallel=True, min_channels=min_ch)
            blocks = [(n, t.shape, parallel.sharded.split_of(t).size) for n, t in
                      [*run.model.named_parameters(), *run.model.named_buffers()] if parallel.sharded.split_of(t)]
            res[name] = {"one": models[name](x), "tp": run(x), "blocks": len(blocks),
                         "halves": all(shape[parallel.sharded.split_of(dict([*run.model.named_parameters(),
                                       *run.model.named_buffers()])[n]).dim] * 2 == size for n, shape, size in blocks)}
        run = parallel.shard_inference(models["repvgg_deploy"], mesh, head_tensor_parallel=True)
        res["head"] = {"one": models["repvgg_deploy"](x), "tp": run(x),
                       "blocks": sorted(n for n, t in run.model.named_parameters() if parallel.sharded.split_of(t))}
        qm = quantize_model(models["repvgg_deploy"], calibration_batches=[inputs["calib"]], min_in_channels=8)
        run = parallel.shard_inference(qm, mesh, tensor_parallel=True, min_channels=8)
        res["int8"] = {"one": qm(x), "tp": run(x),
                       "kernels": sorted(n for n, t in run.model.named_buffers() if n.endswith("kernel_q")
                                         and parallel.sharded.split_of(t))}
    if world == 2:
        # a column-parallel linear whose whole output is gathered: the gradient of each
        # rank's block of the weight, against the one-process one
        gen = torch.Generator().manual_seed(3)
        w, xl, c = torch.randn(6, 4, generator=gen), torch.randn(3, 4, generator=gen), torch.randn(3, 6, generator=gen)
        wr = w[3 * rank: 3 * rank + 3].clone().requires_grad_()
        group = mesh.get_group("model")
        (C.gather_replicated(xl @ wr.t(), group, 1) * c).sum().backward()
        local = wr.grad.clone()
        wr.grad = None
        (C.all_gather(xl @ wr.t(), "model", axis=1, mesh=mesh) * c).sum().backward()
        whole = w.clone().requires_grad_()
        ((xl @ whole.t()) * c).sum().backward()
        res["gather_grad"] = {"replicated": local, "all_gather": wr.grad.clone(),
                              "one": whole.grad[3 * rank: 3 * rank + 3].clone()}
    torch.save(tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, res),
               outdir / f"tp_{rank}.pt")
    dist.barrier()


def spatial_parallel(outdir: Path, rank: int, world: int) -> None:
    """``sp``: ``shard_spatial_inference`` (2 processes: the U-Net gathered and not, the
    classifier at 64 and 67 rows, the train step's loss and gradients, the missing-axis
    error; 4: DP x SP on a ``("data", "spatial")`` mesh and DP x TP on a ``("data",
    "model")`` one), each beside the one-process forward."""
    from torch import distributed as dist

    from holocron_tpu_torch import parallel
    from holocron_tpu_torch.nn import functional as HF
    from holocron_tpu_torch.parallel import sharded

    inputs = torch.load(outdir / "inputs.pt", weights_only=False)
    models = _models(inputs)
    res = {}
    with torch.no_grad():
        if world == 4:
            mesh = parallel.create_mesh(("data", "spatial"), model_parallel=2)
            x = inputs["x_unet"]
            res["dpsp"] = {"one": models["unet"](x),
                           "sp": parallel.shard_spatial_inference(models["unet"], mesh, batch_axis="data")(x)}
            mesh = parallel.create_mesh(("data", "model"), model_parallel=2)
            xc = inputs["x64"]
            res["dptp"] = {"one": models["repvgg64"](xc), "tp": parallel.shard_inference(
                models["repvgg64"], mesh, tensor_parallel=True, min_channels=8)(xc)}
        else:
            x = inputs["x_unet"]
            res["unet"] = {"one": models["unet"](x), "sp": parallel.shard_spatial_inference(models["unet"])(x),
                           "rows": parallel.shard_spatial_inference(models["unet"], gather_output=False)(x)}
            for h in (64, 67):
                xc = inputs[f"x{h}"]
                res[f"repvgg{h}"] = {"one": models[f"repvgg{h}"](xc),
                                     "sp": parallel.shard_spatial_inference(models[f"repvgg{h}"])(xc)}
            try:
                parallel.shard_spatial_inference(models["unet"], parallel.create_mesh(("spatial",)), batch_axis="data")
            except ValueError as err:
                res["missing_axis"] = str(err)
    if world == 2:  # the train step: each rank's rows of the image and the mask
        unet = models["unet"].train()
        xs, ys = inputs["x_step"], inputs["y_step"]
        group = dist.group.WORLD
        with sharded.SplitMode():
            out = unet(sharded.split_rows(xs, 2, group))
            loss = HF.cross_entropy(out.permute(0, 2, 3, 1), sharded.split_rows(ys, 1, group))
        names, params = zip(*unet.named_parameters())
        grads = torch.autograd.grad(loss, params)
        for g in grads:  # the data-parallel rule: every process's gradient, averaged
            dist.all_reduce(g)
            g.div_(world)
        res["step"] = {"loss": loss.detach(), "grads": dict(zip(names, grads))}
    torch.save(tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, res),
               outdir / f"sp_{rank}.pt")
    dist.barrier()


def conv_block(p: dict, h: torch.Tensor) -> torch.Tensor:
    """``tests/test_parallel.py:298-302``'s residual conv block, NCHW."""
    from torch.nn import functional as F

    return F.relu(F.conv2d(h, p["w"], padding=1) + p["b"][:, None, None]) + h


def pipeline(outdir: Path, rank: int, world: int) -> None:
    """``pipeline``: for each microbatch count of ``inputs["microbatches"][world]``, the
    conv stack's output rows and gathered output (no gradient), and the gradients of the
    global sum of squares with respect to the stacked parameters and the input; the
    ``ValueError`` s of bad arguments; darknet53's stage 3 (2 processes)."""
    from holocron_tpu_torch import parallel
    from holocron_tpu_torch.models.classification.darknetv3 import ResBlock

    inputs = torch.load(outdir / "pipeline_inputs.pt", weights_only=False)
    mesh = parallel.create_mesh(axes=("pipe",))
    params, x = inputs["conv"]["params"], inputs["conv"]["x"]
    res = {"conv": {}, "errors": {}}
    for m in inputs["microbatches"][world]:
        with torch.no_grad():
            y = parallel.pipeline_blocks(conv_block, params, x, mesh, num_microbatches=m)
            whole = parallel.pipeline_blocks(conv_block, params, x, mesh, num_microbatches=m, gather_output=True)
        pr = {k: v.clone().requires_grad_() for k, v in params.items()}
        xr = x.clone().requires_grad_()
        (parallel.pipeline_blocks(conv_block, pr, xr, mesh, num_microbatches=m) ** 2).sum().backward()
        res["conv"][m] = {"y": y, "whole": whole, "grads": {k: v.grad for k, v in pr.items()}, "dx": xr.grad}

    def error(name, **kw):
        args = {"stacked_params": params, "x": x, "mesh": mesh, **kw}
        try:
            parallel.pipeline_blocks(conv_block, **args)
        except ValueError as err:
            res["errors"][name] = str(err)

    if world == 4:
        error("spread", num_microbatches=2)  # 2 microbatches over 4 belt shards
    else:
        error("spread", num_microbatches=3)
        error("batch", num_microbatches=6)  # 8 rows into 6 microbatches
        error("stages", stacked_params={k: v[:7] for k, v in params.items()})
        error("axis", mesh=parallel.create_mesh(axes=("data",)))
        d = inputs["darknet"]
        block = ResBlock(512, 256)  # in training mode, which the call must leave as it was
        with torch.no_grad():
            res["darknet"] = parallel.pipeline_module(block, d["stacked"], d["x"], mesh, num_microbatches=8)
        res["darknet_block_training"] = block.training
    torch.save(res, outdir / f"pipeline_{world}_{rank}.pt")


ELASTIC_LR, ELASTIC_STEPS = 5e-3, 4  # check_setup's learning rate, steps before a save and after a restore


def whole_state(trainer) -> dict:
    """Parameters and BN statistics, each tensor held as blocks (of any lengths)
    gathered whole (a collective), as numpy."""
    from holocron_tpu_torch.parallel import collectives, sharded

    def whole(t):
        split = sharded.split_of(t)
        if split is None:
            return t
        return collectives._gather_uneven(t, split.group, split.dim, [hi - lo for lo, hi in split.all_bounds()])

    named = dict([*trainer.model.named_parameters(), *trainer.model.named_buffers()])
    with torch.no_grad():
        return {k: whole(named[k]).numpy().copy() for k, v in trainer.model.state_dict().items()
                if v.is_floating_point()}


def continued(trainer, ckpt) -> dict:
    """``trainer`` restored from ``ckpt``, then 4 steps: the restored state, the losses
    and the final state."""
    trainer.load(str(ckpt))
    restored = whole_state(trainer)
    losses = trainer.check_setup(lr=ELASTIC_LR, num_it=ELASTIC_STEPS)
    return {"restored": restored, "losses": losses, "final": whole_state(trainer)}


def ragged_trainer(world: int):
    """A trainer over two 1x1 convs (3 -> 5 -> 2 channels), the first one's weight and
    bias held in blocks over every process (5 channels: 3 + 2 over 2 processes, 2 + 1 +
    1 + 1 over 4), the second whole."""
    from torch import nn
    from torch.distributed.tensor import Replicate, Shard

    from holocron_tpu_torch import parallel
    from holocron_tpu_torch.parallel.inference import shard_module
    from holocron_tpu_torch.parallel.mesh import Sharding
    from holocron_tpu_torch.trainer import Trainer

    model = nn.Sequential(nn.Conv2d(3, 5, 1), nn.Conv2d(5, 2, 1))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    trainer = Trainer(model, device="cpu")
    if world > 1:
        mesh = parallel.create_mesh(("data", "model"), model_parallel=world)
        shard_module(trainer.model, {n: Sharding(mesh, (Replicate(), Shard(0))) for n in ("0.weight", "0.bias")})
    return trainer


def elastic(outdir: Path, rank: int, world: int, variant: str) -> None:
    from torch import distributed as dist

    from holocron_tpu_torch.parallel import collectives, sharded

    res = {}
    if variant == "save":
        trainer = make_trainer(world, "tp")
        trainer.check_setup(lr=ELASTIC_LR, num_it=ELASTIC_STEPS)
        trainer.save(str(outdir / "tp2.pt"))
        gathers = sharded.gather, collectives._all_gather_cat, collectives._gather_uneven

        def refuse(*args, **kwargs):
            raise AssertionError("the directory save gathered a tensor held as blocks")

        sharded.gather = collectives._all_gather_cat = collectives._gather_uneven = refuse
        try:
            trainer.save(str(outdir / "tp2_dir"))
        finally:
            sharded.gather, collectives._all_gather_cat, collectives._gather_uneven = gathers
        trainer = make_trainer(world, "zero1")
        trainer.check_setup(lr=ELASTIC_LR, num_it=ELASTIC_STEPS)
        trainer.save(str(outdir / "zero1.pt"))
        res["zero1_into_tp2"] = continued(make_trainer(world, "tp"), outdir / "zero1.pt")
        trainer = ragged_trainer(world)
        trainer.epoch, trainer.step = 2, 7
        trainer.save(str(outdir / "ragged_dir"))
    else:
        for name in ("tp2.pt", "tp2_dir"):
            res[f"{name}_into_tp4"] = continued(make_trainer(world, "tp4"), outdir / name)
        trainer = ragged_trainer(world)
        with torch.no_grad():
            for p in trainer.model.parameters():
                p.zero_()
        trainer.load(str(outdir / "ragged_dir"))
        res["ragged"] = {"whole": whole_state(trainer), "step": trainer.step, "epoch": trainer.epoch,
                         "rows": [trainer.model[0].weight.shape[0], trainer.model[0].bias.shape[0]]}
        rows = [None] * world
        dist.all_gather_object(rows, res["ragged"]["rows"])
        res["ragged"]["rows"] = rows
    if rank == 0:
        torch.save(res, outdir / f"elastic_{variant}.pt")


def run_workers(mode: str, nproc: int, outdir: Path, variant: str = "plain", timeout: float = 300) -> None:
    """Runs ``nproc`` workers of ``mode`` on a free port and waits for all; when one
    fails, the others (blocked on a collective) are killed and every output is shown."""
    import socket
    import subprocess
    import time

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(nproc), str(port), str(outdir), variant],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    outs = []
    for p in procs:
        if p.poll() is None:
            p.kill()
        outs.append(p.communicate()[0])
    report = "\n".join(f"--- worker {r} (rc={p.returncode}) ---\n{o}" for r, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 and "WORKER_DONE" in o for p, o in zip(procs, outs)), f"worker failed:\n{report}"


def main() -> None:
    mode, rank, world, port, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], Path(sys.argv[5])
    variant = sys.argv[6] if len(sys.argv) > 6 else "plain"
    torch.set_num_threads(1)
    outdir.mkdir(parents=True, exist_ok=True)
    from torch import distributed as dist

    if mode == "collectives":  # joins from torchrun's environment
        os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
                           "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
        collectives(outdir, rank, world)
    else:
        from holocron_tpu_torch.parallel import initialize

        initialize("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
        if mode == "train":
            train(outdir, world, variant)
        elif mode == "det":
            detection(outdir, rank)
        elif mode == "tp":
            tensor_parallel(outdir, rank, world)
        elif mode == "sp":
            spatial_parallel(outdir, rank, world)
        elif mode == "amp":
            amp_steps(outdir, rank, world)
        elif mode == "pipeline":
            pipeline(outdir, rank, world)
        elif mode == "elastic":
            elastic(outdir, rank, world, variant)
        else:
            raise SystemExit(f"unknown mode {mode}")
    dist.destroy_process_group()
    print(f"[{rank}] WORKER_DONE", flush=True)


if __name__ == "__main__":
    main()
