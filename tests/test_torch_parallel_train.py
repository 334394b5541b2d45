"""Data-parallel training across processes: the port's trainer in two gloo processes
against its one-process run, on the CPU.

Two OS processes (``tests/torch_mp_worker.py``), each with half of every global batch
of 8 (``EpochDataLoader(num_shards="auto")``), must reproduce the one-process run's
final parameters, BN statistics and eval metrics at ``tests/test_multiprocess.py``'s
tolerances: plain, with ``shard_opt_state`` (ZeRO-1), with ``model_parallel=2`` (tensor
parallelism, every channel of 4 or more split) and with ``spatial_parallel=2`` (each
process its rows of every image), the last two over a data axis of 1 and so each process
reading the whole batch of 8. The ZeRO-1 and tensor-parallel checkpoints restore into a
one-process trainer and continue the same trajectory (``tests/test_elastic_restore.py``'s
contract). Under ``amp`` (bf16 compute) the tensor- and spatial-parallel first steps
give the one-process loss and gradients at bf16's precision. The one-process run is
made once, in this process, and shared.
"""

import json

import numpy as np
import pytest
import torch

import torch_mp_worker as W

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
BF16_LOSS_RTOL, BF16_GRAD_TOL = 2.0**-8, 2.0**-6


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("one")
    W.train(outdir, 1)
    return outdir


@pytest.fixture(scope="module")
def zero1(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("zero1")
    W.run_workers("train", 2, outdir, "zero1")
    return outdir


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("tp")
    W.run_workers("train", 2, outdir, "tp")
    return outdir


def _assert_matches(got_dir, want_dir):
    got, want = np.load(got_dir / "state.npz"), np.load(want_dir / "state.npz")
    assert set(got.files) == set(want.files) and any("running_var" in k for k in want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{k} left the one-process run")
    m_got, m_want = (json.loads((d / "metrics.json").read_text()) for d in (got_dir, want_dir))
    assert m_got["steps"] == m_want["steps"] == 8
    assert m_got["acc1"] == pytest.approx(m_want["acc1"], abs=1e-9)
    assert m_got["acc5"] == pytest.approx(m_want["acc5"], abs=1e-9)
    assert m_got["val_loss"] == pytest.approx(m_want["val_loss"], rel=1e-3)
    return m_got, m_want


def test_two_process_training_matches_one_process(tmp_path, one_process):
    """Gradients averaged across the processes, batch norm over the global batch, the
    shard split and the gathered evaluation: the one-process trajectory."""
    W.run_workers("train", 2, tmp_path)
    m_got, m_want = _assert_matches(tmp_path, one_process)
    assert m_got["opt_state_elements"] == [m_want["opt_state_elements"][0]] * 2


def test_two_process_zero1_matches_one_process(zero1, one_process):
    """ZeRO-1: the same trajectory, each rank holding less than all of the optimizer's
    moments and the two together holding them once."""
    m_got, m_want = _assert_matches(zero1, one_process)
    (total,) = m_want["opt_state_elements"]
    assert len(m_got["opt_state_elements"]) == 2 and all(0 < n < total for n in m_got["opt_state_elements"])
    assert sum(m_got["opt_state_elements"]) == total


def test_two_process_tensor_parallel_matches_one_process(tp, one_process):
    """``model_parallel=2``: each process holds half of every split parameter, BN
    statistic and optimizer moment (so fewer optimizer elements than one process, the
    stem's and head's narrow tensors whole), the gradients averaged over the data group
    of 1; the checkpoint holds whole tensors: the one-process trajectory."""
    m_got, m_want = _assert_matches(tp, one_process)
    (total,) = m_want["opt_state_elements"]
    assert len(m_got["opt_state_elements"]) == 2 and all(0 < n < total for n in m_got["opt_state_elements"])


def test_two_process_spatial_parallel_matches_one_process(tmp_path, one_process):
    """``spatial_parallel=2``: each process its rows of every batch, the halos exchanged,
    batch norm and the global pool summed over both: the one-process trajectory."""
    W.run_workers("train", 2, tmp_path, "spatial")
    m_got, m_want = _assert_matches(tmp_path, one_process)
    assert m_got["opt_state_elements"] == [m_want["opt_state_elements"][0]] * 2


@pytest.fixture(scope="module")
def amp_steps(tmp_path_factory):
    """The first step under ``amp`` in two processes (``tp`` and ``spatial``) and in one."""
    outdir = tmp_path_factory.mktemp("amp")
    W.run_workers("amp", 2, outdir)
    return torch.load(outdir / "amp.pt", weights_only=False), W.amp_first_step(1)


@pytest.mark.parametrize("variant", ["tp", "spatial"])
def test_two_process_amp_first_step_matches_one_process(amp_steps, variant):
    """Under ``amp`` (bf16 compute, the CLIs' ``--amp``), ``model_parallel=2`` and
    ``spatial_parallel=2``: the first step's loss and every gradient the update takes
    are the one-process step's at bf16's precision (the split layers and halves sum in
    another order): the loss within 2^-8 relative, each gradient within 2^-6 of its
    largest magnitude."""
    got, want = amp_steps
    got = got[variant]
    assert got["loss"] == pytest.approx(want["loss"], rel=BF16_LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        scale = float(np.abs(g).max())
        assert scale > 0, k
        np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=BF16_GRAD_TOL * scale, err_msg=k)


def _restore_and_continue(ckpt, steps: int = 4):
    trainer = W.make_trainer(1)
    trainer.load(str(ckpt))
    restored = W.state_arrays(trainer.model)
    losses = trainer.check_setup(lr=5e-3, num_it=steps)
    return restored, losses, W.state_arrays(trainer.model)


def test_zero1_checkpoint_restores_into_one_process(zero1, one_process):
    """The two-process ZeRO-1 run's checkpoint (the model alone, written by rank 0)
    restores into a one-process trainer bit for bit and continues the trajectory of the
    one-process run's own checkpoint."""
    restored, losses, final = _restore_and_continue(zero1 / "trainer.pt")
    saved = np.load(zero1 / "state.npz")
    for k in saved.files:
        np.testing.assert_array_equal(restored[k], saved[k])
    _, base_losses, base_final = _restore_and_continue(one_process / "trainer.pt")
    np.testing.assert_allclose(losses, base_losses, rtol=RTOL, atol=ATOL)
    for k, v in base_final.items():
        np.testing.assert_allclose(final[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_tensor_parallel_checkpoint_restores_into_one_process(tp, one_process):
    """The two-process tensor-parallel run's checkpoint (whole tensors, gathered and
    written by rank 0) restores into a one-process trainer bit for bit and continues the
    trajectory of the one-process run's own checkpoint."""
    restored, losses, final = _restore_and_continue(tp / "trainer.pt")
    saved = np.load(tp / "state.npz")
    for k in saved.files:
        np.testing.assert_array_equal(restored[k], saved[k])
    _, base_losses, base_final = _restore_and_continue(one_process / "trainer.pt")
    np.testing.assert_allclose(losses, base_losses, rtol=RTOL, atol=ATOL)
    for k, v in base_final.items():
        np.testing.assert_allclose(final[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
