"""Checkpoint directories written by every process, each its own blocks: the
counterpart of the JAX trainer's orbax path (``holocron_tpu/trainer/core.py:277-320``).

A ``torch.distributed.checkpoint`` directory: every process takes part, each tensor held
as blocks (tensor parallelism's splits) is written by each process as its own block at
its global offsets, whole tensors once, so nothing is gathered; a load reads into any
layout, each block from the pieces of the saved chunks that overlap it.

The blocks follow ``torch.tensor_split`` (the first ``size % n`` one longer), which a
``DTensor``'s ``Shard`` (``torch.chunk``) does not, so they reach the checkpoint's chunk
metadata through the planners here and not as ``DTensor`` s: a block is a chunk of its
own offsets and sizes.
"""

import dataclasses
import warnings
from pathlib import Path
from typing import Dict, Mapping, Tuple

import torch
from torch.distributed import checkpoint as dcp
from torch.distributed.checkpoint.default_planner import create_default_local_load_plan
from torch.distributed.checkpoint.metadata import ChunkStorageMetadata, MetadataIndex
from torch.distributed.checkpoint.planner import TensorWriteData, WriteItem, WriteItemType
from torch.distributed.checkpoint.planner_helpers import create_read_items_for_chunk_list

from ..parallel.sharded import Split

META = ("epoch", "step", "min_loss")
# a block's global offsets and the whole tensor's size, by key of the checkpoint
Blocks = Dict[str, Tuple[torch.Size, torch.Size]]
ONE_PROCESS = "torch.distributed is disabled"  # DCP's warning whenever no group is joined


def _blocks(state: Mapping[str, torch.Tensor], splits: Mapping[str, Split]) -> Blocks:
    out = {}
    for name, split in splits.items():
        t = state[name]
        offsets, size = [0] * t.ndim, list(t.shape)
        offsets[split.dim], size[split.dim] = split.bounds()[0], split.size
        out[f"model.{name}"] = (torch.Size(offsets), torch.Size(size))
    return out


class _BlockSavePlanner(dcp.DefaultSavePlanner):
    """Writes each block as the chunk at its offsets of the whole tensor."""

    def __init__(self, blocks: Blocks) -> None:
        super().__init__()
        self.blocks = blocks

    def create_local_plan(self):
        plan = super().create_local_plan()
        items = []
        for item in plan.items:
            if item.index.fqn in self.blocks:
                offsets, size = self.blocks[item.index.fqn]
                data = item.tensor_data
                item = WriteItem(index=MetadataIndex(item.index.fqn, offsets), type=WriteItemType.SHARD,
                                 tensor_data=TensorWriteData(ChunkStorageMetadata(offsets, data.chunk.sizes),
                                                             data.properties, size))
            items.append(item)
        self.plan = dataclasses.replace(plan, items=items)
        return self.plan

    def lookup_object(self, index: MetadataIndex):
        if index.fqn in self.blocks:
            return self.state_dict[index.fqn]
        return super().lookup_object(index)


class _BlockLoadPlanner(dcp.DefaultLoadPlanner):
    """Reads each block from the saved chunks that overlap its offsets."""

    def __init__(self, blocks: Blocks) -> None:
        super().__init__()
        self.blocks = blocks

    def create_local_plan(self):
        md = self.metadata.state_dict_metadata
        whole = {k: v for k, v in self.state_dict.items() if k not in self.blocks}
        plan = create_default_local_load_plan(whole, self.metadata)
        for key, (offsets, size) in self.blocks.items():
            if key not in md:
                raise RuntimeError(f"Missing key in checkpoint state_dict: {key}.")
            if md[key].size != size:
                raise ValueError(f"Size mismatch between saved {md[key].size} and current: {size} for {key}")
            chunk = ChunkStorageMetadata(offsets, self.state_dict[key].shape)
            plan.items.extend(create_read_items_for_chunk_list(key, md[key], [chunk]))
        return plan

    def lookup_tensor(self, index: MetadataIndex) -> torch.Tensor:
        if index.fqn in self.blocks:
            return self.state_dict[index.fqn]
        return super().lookup_tensor(index)


def save_directory(path: Path, meta: Mapping, state: Mapping[str, torch.Tensor], splits: Mapping[str, Split]) -> None:
    """Writes ``meta`` (epoch, step, min_loss) and the model's ``state`` (this process's
    blocks of the tensors in ``splits``, whole tensors as they are) to the directory
    ``path``. A collective: every process calls it in lockstep."""
    path.mkdir(parents=True, exist_ok=True)
    sd = {**{k: meta[k] for k in META}, **{f"model.{k}": v for k, v in state.items()}}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=ONE_PROCESS)
        dcp.save(sd, checkpoint_id=str(path), planner=_BlockSavePlanner(_blocks(state, splits)))


def load_directory(path: Path, state: Mapping[str, torch.Tensor], splits: Mapping[str, Split]) -> Dict:
    """Reads a directory of :func:`save_directory` for a model whose ``state_dict`` is
    ``state``: ``{epoch, step, min_loss, model}``, each tensor in ``splits`` as this
    process's block of it. A collective under a process group."""
    targets = {f"model.{k}": torch.empty_like(v) for k, v in state.items()}
    sd = {**{k: None for k in META}, **targets}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=ONE_PROCESS)
        dcp.load(sd, checkpoint_id=str(path), planner=_BlockLoadPlanner(_blocks(state, splits)))
    return {**{k: sd[k] for k in META}, "model": {k: sd[f"model.{k}"] for k in state}}
