#!/usr/bin/env python
"""Strips the trainer's state from a checkpoint for release, the port of
``references/clean_checkpoint.py``:

    python -m holocron_tpu_torch.references.clean_checkpoint checkpoint.pt model.pth

Keeps the ``model`` state dict of a checkpoint that ``Trainer.save`` wrote (a file that
holds a state dict alone passes as it is), writes it with ``torch.save``, and prints the
number of parameters it holds (every floating-point tensor but the batch norms' running
statistics).
"""

import argparse
from typing import List, Optional

import torch

_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def main(args) -> int:
    state = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    model_state = state["model"] if "model" in state else state
    torch.save(model_state, args.output)
    num_params = sum(t.numel() for k, t in model_state.items()
                     if t.is_floating_point() and not k.endswith(_STATISTICS))
    print(f"Saved cleaned checkpoint ({num_params} params) to {args.output}")  # noqa: T201
    return num_params


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="Checkpoint cleanup")
    parser.add_argument("checkpoint", type=str, help="path to the trainer checkpoint")
    parser.add_argument("output", type=str, help="destination path")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
