"""The deploy forward captured once per batch bucket: the port's counterpart of the JAX
``Model``'s jit-cached eval forward and of ``Model.deploy_forward()``
(``holocron_tpu/models/core.py:1-10``, ``:118-135``).

JAX compiles one program per input shape and replays it. The port's counterpart of a
compiled program is a CUDA graph: :func:`deploy_forward` captures one
``torch.cuda.CUDAGraph`` per batch bucket, all in one memory pool, over static input
and output buffers. A call copies the batch into its bucket's input and replays the
graph, one launch from the host where the eager forward makes one a kernel (about 400
for a rexnet1_0x forward).
"""

import contextlib
import functools
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

__all__ = ["WARMUP", "cudnn_settings", "deploy_forward", "softmax_forward"]

MeanStd = Tuple[Sequence[float], Sequence[float]]
Outputs = Union[torch.Tensor, Tuple, List, Dict[str, torch.Tensor]]
WARMUP = 2  # eager forwards a bucket before its capture


@contextlib.contextmanager
def cudnn_settings(**values: bool) -> Iterator[None]:
    """Sets the named ``torch.backends.cudnn`` flags (``benchmark``, ``deterministic``,
    ``allow_tf32``) for the block and restores them after it. (``cudnn.flags`` would
    also reset the flags it is not given.)"""
    cudnn = torch.backends.cudnn
    saved = {name: getattr(cudnn, name) for name in values}
    try:
        for name, value in values.items():
            setattr(cudnn, name, value)
        yield
    finally:
        for name, value in saved.items():
            setattr(cudnn, name, value)


def softmax_forward(model: nn.Module, u8: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """The service's device program (``api/app/vision.py:104-110``): uint8 NHWC images,
    ``(x / 255 - mean) / std`` in float32 on their NCHW view (channels_last, as the
    permute leaves them), the model in the dtype of its parameters, and the softmax of
    its logits in float32.

    ``mean`` and ``std``: float32 ``(1, 3, 1, 1)`` tensors on ``u8``'s device."""
    x = (u8.permute(0, 3, 1, 2).float() * (1.0 / 255.0) - mean) / std
    return torch.softmax(model(x.to(_model_dtype_device(model)[0])).float(), dim=-1)


def _model_dtype_device(model: nn.Module) -> Tuple[torch.dtype, torch.device]:
    params = [p for p in model.parameters() if p.is_floating_point()]
    if not params:
        raise ValueError("the model has no floating-point parameters")
    return params[0].dtype, params[0].device


def deploy_forward(
    model: nn.Module,
    buckets: Sequence[int],
    image_size: int = 224,
    mean_std: Optional[MeanStd] = None,
    forward: Optional[Callable[[torch.Tensor], Outputs]] = None,
) -> Callable[[torch.Tensor], Outputs]:
    """Returns the forward of ``model`` (eval or deploy form, already reparametrized or
    quantized; its forward is taken as it is) for batches of up to ``max(buckets)``.

    Three forms:

    - ``mean_std=(mean, std)``: uint8 NHWC ``(N, image_size, image_size, 3)`` images in,
      probabilities out (:func:`softmax_forward`, the service's form);
    - ``mean_std=None``: normalized NCHW ``(N, 3, image_size, image_size)`` input in the
      model's dtype, logits out (the headline bench's form);
    - ``forward``: the same input, and whatever ``forward`` (a function of the model, on
      its device, with no host sync: e.g. a detector's raw forward followed by
      ``post_process``) returns, a tensor or a tuple, list or dict of tensors whose first
      dimension is the batch.

    It runs where the model's parameters lie. On the card each bucket is captured once as a CUDA graph after :data:`WARMUP` forwards on a side stream (cuDNN's
    autotuning runs there, never inside a capture), so the graph runs the kernels, and
    the cuDNN and TF32 settings, in force when this is called. A call pads the batch to
    the smallest bucket that holds it with copies of its last sample (which leaves a
    per-batch dynamic activation scale unchanged), copies it into the bucket's static
    input on the current stream, replays the graph and returns the first N rows of the
    bucket's static output (or outputs): valid until the next call, so copy it out
    (``.cpu()``) before calling again. One caller at a time. The returned forward holds the model
    and the mean and std it normalizes with: a graph reads them where they lay at
    capture. A failed capture raises; nothing falls back to running eagerly. For a
    model on the CPU the same function runs eagerly on each call (the entry points,
    ``api.config.device()`` and ``bench.run``, raise without a card unless the CPU is
    asked for).
    """
    buckets = tuple(sorted({int(b) for b in buckets}))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive batch sizes, got {buckets}")
    dtype, device = _model_dtype_device(model)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the model's parameters lie on {device}, neither a CUDA device nor the CPU")
    if mean_std is None:
        fn = model if forward is None else forward
        shape = (3, image_size, image_size)
    else:
        mean, std = (torch.tensor(v, dtype=torch.float32, device=device).reshape(1, -1, 1, 1) for v in mean_std)
        fn = functools.partial(softmax_forward, model, mean=mean, std=std)
        shape = (image_size, image_size, 3)

    if device.type == "cpu":
        def eager(batch: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return fn(batch)

        return eager

    return _CapturedForward(fn, buckets, shape, torch.uint8 if mean_std is not None else dtype, device)


class _CapturedForward:
    """One CUDA graph a bucket over static buffers, and what the graphs read: the
    forward ``fn`` (the model's weights, mean and std) lives as long as they do."""

    def __init__(self, fn: Callable, buckets: Tuple[int, ...], shape: Tuple[int, ...], dtype: torch.dtype,
                 device: torch.device) -> None:
        self.fn, self.buckets, self.shape = fn, buckets, shape
        self.inputs, self.outputs, self.graphs = {}, {}, {}
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(device)
        with torch.cuda.device(device), torch.no_grad():
            for b in reversed(buckets):  # the largest first: the smaller ones reuse its pool's blocks
                static = torch.zeros((b, *shape), dtype=dtype, device=device)
                if dtype != torch.uint8:
                    static = static.contiguous(memory_format=torch.channels_last)
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(WARMUP):
                        fn(static)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    self.outputs[b] = fn(static)
                self.inputs[b], self.graphs[b] = static, graph
        torch.cuda.synchronize(device)

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        n, shape = batch.shape[0], self.shape
        if tuple(batch.shape[1:]) != shape or n < 1:
            raise ValueError(f"expected a batch of shape (N, {', '.join(map(str, shape))}), got {tuple(batch.shape)}")
        b = next((b for b in self.buckets if b >= n), None)
        if b is None:
            raise ValueError(f"a batch of {n} exceeds the largest bucket, {self.buckets[-1]}")
        static = self.inputs[b]
        static[:n].copy_(batch)
        if n < b:
            static[n:].copy_(static[n - 1 : n].expand(b - n, *shape))
        self.graphs[b].replay()
        return _first_rows(self.outputs[b], n)


def _first_rows(out: Outputs, n: int) -> Outputs:
    """The first ``n`` rows of each tensor of ``out``."""
    if isinstance(out, torch.Tensor):
        return out[:n]
    if isinstance(out, dict):
        return {k: _first_rows(v, n) for k, v in out.items()}
    return type(out)(_first_rows(v, n) for v in out)
