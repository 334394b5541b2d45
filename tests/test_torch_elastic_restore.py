"""Checkpoints that restore across layouts: the port's counterpart of
``tests/test_elastic_restore.py:89,107,119``, on the CPU.

A checkpoint written under one layout restores into another and continues the
one-process trajectory: the one-process run trains 4 steps (``check_setup``), saves,
restores into a fresh one-process trainer and trains 4 more; every other arm trains its
4 steps under its layout, saves, restores under another and trains 4 more, all within
``tests/test_torch_parallel_train.py``'s ``RTOL, ATOL = 2e-4, 2e-5`` of it. The
optimizer state is not in a checkpoint, so every arm restarts it at the restore.

- tensor-parallel (2 processes) to a file, restored into ``model_parallel=4``;
- tensor-parallel (2) to a directory (a path with no suffix: each process writes its
  own blocks, nothing is gathered), restored into one process and into 4;
- ZeRO-1 (2) to a file, restored into tensor-parallel (2);
- a directory of a model with a tensor in blocks of unequal length (5 channels over 2
  processes, 3 + 2) restored into one process and into 4 (2 + 1 + 1 + 1).

One spawn of 2 processes writes every checkpoint and runs the ZeRO-1 restore, one of 4
the 4-process restores (``tests/torch_mp_worker.py``'s ``elastic`` mode).
"""

import numpy as np
import pytest
import torch
from torch.distributed.checkpoint import FileSystemReader

import torch_mp_worker as W

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("elastic")
    W.run_workers("elastic", 2, outdir, "save")
    W.run_workers("elastic", 4, outdir, "restore")
    return outdir, {v: torch.load(outdir / f"elastic_{v}.pt", weights_only=False) for v in ("save", "restore")}


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """One process: 4 steps, a file, restored into a fresh trainer, 4 more steps."""
    path = tmp_path_factory.mktemp("base") / "base.pt"
    trainer = W.make_trainer(1)
    trainer.check_setup(lr=W.ELASTIC_LR, num_it=W.ELASTIC_STEPS)
    trainer.save(str(path))
    saved = W.whole_state(trainer)
    run = W.continued(W.make_trainer(1), path)
    for k, v in saved.items():
        np.testing.assert_array_equal(run["restored"][k], v)
    return {"saved": saved, **run}


def _assert_close(got: dict, want: dict) -> None:
    assert set(got) == set(want) and any("running_var" in k for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def _assert_continues(run: dict, baseline: dict) -> None:
    """The restore held the saved model (which matched the one-process one), and the 4
    steps after it the one-process run's."""
    _assert_close(run["restored"], baseline["saved"])
    np.testing.assert_allclose(run["losses"], baseline["losses"], rtol=RTOL, atol=ATOL)
    _assert_close(run["final"], baseline["final"])


def test_tp2_file_restores_into_tp4(runs, baseline):
    """A tensor-parallel file (whole tensors, rank 0) restores into 4-way tensor
    parallelism, each process taking its quarter, and continues the trajectory."""
    _, res = runs
    _assert_continues(res["restore"]["tp2.pt_into_tp4"], baseline)


def test_tp2_directory_holds_only_blocks(runs):
    """The directory of the tensor-parallel run holds every split tensor as two chunks,
    one a process at its offsets (the save ran with every gather refused), and the whole
    tensors once."""
    outdir, _ = runs
    md = FileSystemReader(str(outdir / "tp2_dir")).read_metadata().state_dict_metadata
    saved = torch.load(outdir / "tp2.pt", weights_only=True)["model"]
    split = 0
    for name, whole in saved.items():
        entry = md[f"model.{name}"]
        assert tuple(entry.size) == tuple(whole.shape), name
        if len(entry.chunks) == 1:
            assert tuple(entry.chunks[0].sizes) == tuple(whole.shape), name
            continue
        split += 1
        half = whole.shape[0] // 2
        assert sorted((c.offsets[0], c.sizes[0]) for c in entry.chunks) == [(0, half), (half, half)], name
    assert split > 0


def test_tp2_directory_restores_into_one_process(runs, baseline):
    """The tensor-parallel directory restores into one process, each tensor assembled
    from the two processes' chunks, bit for bit the file's tensors, and continues the
    trajectory."""
    outdir, _ = runs
    run = W.continued(W.make_trainer(1), outdir / "tp2_dir")
    saved = torch.load(outdir / "tp2.pt", weights_only=True)["model"]
    for k, v in run["restored"].items():
        np.testing.assert_array_equal(v, saved[k].numpy(), err_msg=k)
    _assert_continues(run, baseline)


def test_tp2_directory_restores_into_tp4(runs, baseline):
    """The tensor-parallel directory restores into 4-way tensor parallelism, each process
    reading its quarter from one process's chunk, and continues the trajectory."""
    _, res = runs
    _assert_continues(res["restore"]["tp2_dir_into_tp4"], baseline)


def test_zero1_file_restores_into_tp2(runs, baseline):
    """A ZeRO-1 checkpoint (the model alone, whole) restores into 2-way tensor
    parallelism and continues the trajectory."""
    _, res = runs
    _assert_continues(res["save"]["zero1_into_tp2"], baseline)


def test_ragged_blocks_restore_across_layouts(runs):
    """A tensor in blocks of unequal length (5 channels: 3 + 2 over 2 processes) is saved
    as chunks of those lengths and restores whole into one process and as 2 + 1 + 1 + 1
    into 4, the epoch and step with it."""
    outdir, res = runs
    md = FileSystemReader(str(outdir / "ragged_dir")).read_metadata().state_dict_metadata
    assert sorted((c.offsets[0], c.sizes[0]) for c in md["model.0.weight"].chunks) == [(0, 3), (3, 2)]
    trainer = W.ragged_trainer(1)
    want = W.whole_state(trainer)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.zero_()
    trainer.load(str(outdir / "ragged_dir"))
    assert (trainer.epoch, trainer.step) == (2, 7)
    for got in (W.whole_state(trainer), res["restore"]["ragged"]["whole"]):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    four = res["restore"]["ragged"]
    assert (four["epoch"], four["step"]) == (2, 7)
    assert four["rows"] == [[2, 2], [1, 1], [1, 1], [1, 1]]
