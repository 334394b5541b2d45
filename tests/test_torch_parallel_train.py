"""Data-parallel training across processes: the port's trainer in two gloo processes
against its one-process run, on the CPU.

Two OS processes (``tests/torch_mp_worker.py``), each with half of every global batch
of 8 (``EpochDataLoader(num_shards="auto")``), must reproduce the one-process run's
final parameters, BN statistics and eval metrics at ``tests/test_multiprocess.py``'s
tolerances: plain, and with ``shard_opt_state`` (ZeRO-1), whose checkpoint restores into
a one-process trainer and continues the same trajectory (``tests/test_elastic_restore.py``'s
contract). The one-process run is made once, in this process, and shared.
"""

import json

import numpy as np
import pytest
import torch

import torch_mp_worker as W

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5


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
