"""The port's data parallelism across processes (``holocron_tpu_torch/parallel``), on the
CPU: the loader's shard split against the JAX package's ``DataLoader``, the process
group joined from ``torchrun``'s environment, the named collectives and their
gradients, the cross-process batch norm, and the detection counters summed over two
gloo processes (``tests/torch_mp_worker.py``). The training trajectories are in
``tests/test_torch_parallel_train.py``.
"""

import copy
import json

import numpy as np
import pytest
import torch
from torch import nn

import torch_mp_worker as W
from holocron_tpu.utils.data import DataLoader as JaxDataLoader
from holocron_tpu_torch.nn.modules._norm import FlaxBatchNorm2d
from holocron_tpu_torch.parallel import CrossProcessBatchNorm2d, convert_batchnorm
from holocron_tpu_torch.trainer import ClassificationTrainer
from holocron_tpu_torch.utils.data import EpochDataLoader

torch.set_num_threads(2)


class Indices:
    def __init__(self, n: int) -> None:
        self.n = n
        self.epoch = None

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        return torch.tensor([i]), torch.tensor(-1 if self.epoch is None else self.epoch)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch


def _indices(loader) -> list:
    return [[int(v) for v in np.asarray(x).reshape(-1)] for x, _ in loader]


@pytest.mark.parametrize("n,shards,batch", [(10, 2, 3), (11, 2, 4), (13, 3, 2), (16, 4, 4)])
def test_shard_split_equals_the_jax_loader(n, shards, batch):
    """Without a shuffle each shard's batches are the JAX loader's, index for index
    (wrap-padded, strided), and every shard has the same length."""
    for i in range(shards):
        ours = EpochDataLoader(Indices(n), batch, num_shards=shards, shard_index=i)
        theirs = JaxDataLoader(Indices(n), batch, num_workers=0, num_shards=shards, shard_index=i)
        assert _indices(ours) == _indices(theirs)
        assert len(ours) == len(theirs) == -(-(-(-n // shards)) // batch)
    with pytest.raises(ValueError):
        EpochDataLoader(Indices(n), batch, num_shards=shards, shard_index=shards)


@pytest.mark.parametrize("shuffle", [False, True])
def test_one_shard_is_the_torch_loader_order(shuffle):
    """One shard, the loader's default: the batches torch's own ``DataLoader`` gives with
    the same seeded generator (its random or sequential sampler), epoch after epoch."""
    ours = EpochDataLoader(Indices(20), 6, shuffle=shuffle, seed=4)
    theirs = torch.utils.data.DataLoader(Indices(20), 6, shuffle=shuffle,
                                         generator=torch.Generator().manual_seed(4) if shuffle else None)
    for _ in range(3):
        assert _indices(ours) == _indices(theirs)


def test_shuffled_shards_are_the_one_process_batches():
    """With a shuffle every shard draws the one-process loader's permutation: a step's
    shards together are its batch, as a set, epoch after epoch."""
    one = EpochDataLoader(Indices(32), 8, shuffle=True, seed=3)
    shards = [EpochDataLoader(Indices(32), 4, shuffle=True, seed=3, num_shards=2, shard_index=i) for i in range(2)]
    for _ in range(3):
        whole, parts = _indices(one), [_indices(s) for s in shards]
        assert len(parts[0]) == len(parts[1]) == len(whole) == 4
        assert [sorted(a + b) for a, b in zip(*parts)] == [sorted(w) for w in whole]
    assert _indices(EpochDataLoader(Indices(32), 8, shuffle=True, seed=3)) != _indices(one)  # a new epoch's order


def test_shard_with_a_spawned_worker_and_set_epoch():
    """A shard read by a spawned worker is the shard read in process, and the epoch (0;
    -1 unset) reaches the dataset before the worker receives it."""
    kw = {"shuffle": True, "seed": 1, "num_shards": 2, "shard_index": 1}
    a = list(EpochDataLoader(Indices(12), 4, **kw))
    b = list(EpochDataLoader(Indices(12), 4, num_workers=1, **kw))
    assert [x.tolist() for x, _ in a] == [x.tolist() for x, _ in b] and len(b) == 2
    assert all(int(e) == 0 for _, t in b for e in t)


def test_initialize_and_collectives_across_two_processes(tmp_path):
    """``initialize()`` joins gloo from RANK / WORLD_SIZE / MASTER_* and a second call
    keeps the group; each collective on the ``data`` axis of ``create_mesh()``, and its
    gradient, is JAX's under ``shard_map``; the mesh's errors; a batch placed and
    gathered; the cross-process batch norm equals ``nn.BatchNorm2d`` on the whole batch
    (output, input and parameter gradients, running statistics)."""
    W.run_workers("collectives", 2, tmp_path)
    out = [json.loads((tmp_path / f"collectives_{r}.json").read_text()) for r in range(2)]
    for r, o in enumerate(out):
        assert (o["world"], o["rank"], o["backend"], o["same_group"], o["num_slices"]) == (2, r, "gloo", True, 1)
        assert o["mesh"] == [["data", "model"], [2, 1]] and o["axis"] == [r, 2, 0, 1]
        assert o["psum"] == [[10.0, 12.0], [14.0, 16.0]] and o["psum_grad"] == [[3.0, 3.0], [3.0, 3.0]]
        assert o["pmean"] == [[5.0, 6.0], [7.0, 8.0]]
        assert o["all_gather"] == [[0.0, 1.0, 10.0, 11.0], [2.0, 3.0, 12.0, 13.0]]
        assert o["all_gather_grad"] == [[[0.0, 2.0], [8.0, 10.0]], [[4.0, 6.0], [12.0, 14.0]]][r]
        assert o["all_gather_stacked"] == [2, 2, 2]
        assert o["reduce_scatter"] == [[[10.0, 12.0]], [[14.0, 16.0]]][r]
        assert o["reduce_scatter_grad"] == [[1.0, 1.0], [2.0, 2.0]]
        x_other = [[10.0, 11.0], [12.0, 13.0]] if r == 0 else [[0.0, 1.0], [2.0, 3.0]]
        assert o["ppermute"] == x_other and o["ppermute_grad"] == ([[2.0] * 2] * 2 if r == 0 else [[1.0] * 2] * 2)
        assert o["ppermute_partial"] == ([[0.0, 0.0], [0.0, 0.0]] if r == 0 else [[0.0, 1.0], [2.0, 3.0]])
        assert o["host_local_put"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
        assert o["shard_batch_local"] == np.arange(12.0).reshape(4, 3)[2 * r : 2 * r + 2].tolist()
        assert o["shard_batch_whole"] == np.arange(12.0).reshape(4, 3).tolist()
        assert o["mp3_error"] == "2 devices cannot host a model-parallel factor of 3"
        assert o["data_axis_sharding"] == ["S(0)", "R"]
        assert o["converted"] == "CrossProcessBatchNorm2d"
        assert max(o["bn_errors"].values()) < 2e-6, o["bn_errors"]
        assert o["all_reduce_grads_equal_mean"]


def test_detection_counters_match_one_process(tmp_path):
    """Each process evaluates its shard; the summed counters give every process the
    one-process metrics (the stub misses the odd samples' boxes: loc_err 0.5)."""
    W.run_workers("det", 2, tmp_path)
    one = W.detection(tmp_path, "one")
    assert one["loc_err"] == pytest.approx(0.5)
    for r in range(2):
        assert json.loads((tmp_path / f"det_{r}.json").read_text()) == one


def test_cross_process_batchnorm_is_the_batchnorm_in_one_process():
    """Without a process group (or in a group of one) the converted batch norms are the
    modules they replace, bit for bit, in training and in eval, running statistics
    included; both kinds convert, holding the same tensors."""
    gen = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4), nn.ReLU(), FlaxBatchNorm2d(4), nn.LayerNorm(6))
    ref = copy.deepcopy(model)
    weight = model[1].weight
    convert_batchnorm(model)
    assert [type(m).__name__ for m in model] == ["Conv2d", "CrossProcessBatchNorm2d", "ReLU",
                                                 "CrossProcessFlaxBatchNorm2d", "LayerNorm"]
    assert model[1].weight is weight and not model[1].flax_running_var and model[3].flax_running_var
    x = torch.randn(4, 3, 8, 8, generator=gen)
    for mode in ("train", "eval"):
        model.train(mode == "train")
        ref.train(mode == "train")
        assert torch.equal(model(x), ref(x))
        for a, b in zip(model.buffers(), ref.buffers()):
            assert torch.equal(a, b)
    assert isinstance(model[1], nn.BatchNorm2d) and isinstance(model[1], CrossProcessBatchNorm2d)


def test_trainer_parallel_options_in_one_process(tmp_path):
    """One process: ``_host_batch`` is the first rows, a batch is placed as it is, one
    process cannot host a tensor or spatial factor of 2 and the two do not combine,
    ``shard_opt_state`` is accepted and partitions nothing, and ``plot_top_losses``
    refuses more than one process."""
    trainer = W.make_trainer(1)
    model = trainer.model
    for kw in ({"model_parallel": 2}, {"spatial_parallel": 2}):
        with pytest.raises(ValueError, match="1 devices cannot host a (model|spatial)-parallel factor of 2"):
            ClassificationTrainer(model, device="cpu", **kw)
    with pytest.raises(ValueError, match="cannot be combined"):
        ClassificationTrainer(model, device="cpu", model_parallel=2, spatial_parallel=2)
    trainer = ClassificationTrainer(model, device="cpu", optimizer=trainer.optimizer, shard_opt_state=True)
    assert (trainer.distributed, trainer.world_size, trainer.rank) == (False, 1, 0)
    trainer._reset_opt(1e-3)
    assert trainer._owned == [] and trainer._opt is not None
    x = torch.arange(6.0).reshape(3, 2)
    assert trainer._place((x, x))[0] is x
    torch.testing.assert_close(trainer._host_batch(x, 2), x[:2])
    trainer.world_size = 2
    with pytest.raises(NotImplementedError, match="single-host"):
        trainer.plot_top_losses((0.5,) * 3, (0.5,) * 3, classes=list("abcde"))
