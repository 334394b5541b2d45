"""Request micro-batching for the inference service (``api/app/batcher.py``).

Concurrent requests coalesce here into one padded model call. Batch sizes are bucketed
to powers of two, the buckets :func:`..models.core.deploy_forward` captures once each.

Dispatch policy, as in the JAX service: **batch-while-busy**. A request that arrives
while the worker is idle dispatches at once; requests that arrive while a device call
is in flight coalesce in the queue, and only then does the worker wait up to
``max_wait_ms`` for more followers.

On the card the worker thread sets its CUDA device and issues the host-to-device copy,
the graph replay and the copy back on one stream of its own (a thread's current device
and stream are not the main thread's).
"""

import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["MicroBatcher"]

Item = Tuple[np.ndarray, float, Future]


class MicroBatcher:
    """Coalesces single-sample inference requests into batched model calls.

    Args:
        infer_fn: ``(N, H, W, C) array -> (N, num_classes) array`` batched model
        max_batch: largest coalesced batch (power of two recommended)
        max_wait_ms: grace window for followers once at least one is already queued
        device: the CUDA device ``infer_fn`` runs on, or None (the CPU)
    """

    def __init__(self, infer_fn: Callable, max_batch: int = 8, max_wait_ms: float = 5.0,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.infer_fn = infer_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.device = None if device is None or torch.device(device).type == "cpu" else torch.device(device)
        if self.device is not None and self.device.index is None:  # the worker sets it: give it an index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._queue: "queue.Queue[Optional[Item]]" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        """Blocks until the (1, ...) sample's result is available.

        Returns ``{"probs": (num_classes,), "queue_ms": float, "infer_ms": float,
        "batch_size": int}``: the per-stage attribution the service surfaces as
        response headers.
        """
        fut: Future = Future()
        self._queue.put((np.asarray(x), time.perf_counter(), fut))
        return fut.result()

    def close(self, timeout: float = 60.0) -> None:
        """Stops the worker once the requests queued before this call are answered."""
        self._queue.put(None)
        self._worker.join(timeout)

    def _drain(self) -> List[Item]:
        first = self._queue.get()  # block for the first request
        if first is None:
            return []
        items = [first]
        # batch-while-busy: only extend the window when a follower is ALREADY here
        # (arrived during the previous device call); an idle queue dispatches now
        deadline = None
        while len(items) < self.max_batch:
            try:
                if deadline is None:
                    item = self._queue.get_nowait()
                else:
                    item = self._queue.get(timeout=max(deadline - time.perf_counter(), 0))
            except queue.Empty:
                if deadline is not None or len(items) == 1:
                    break
                deadline = time.perf_counter() + self.max_wait
                continue
            if item is None:  # close(): answer this batch, then stop
                self._queue.put(None)
                break
            items.append(item)
        return items

    def _run(self) -> None:
        if self.device is None:
            self._serve()
            return
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(torch.cuda.Stream(self.device)):
            self._serve()

    def _serve(self) -> None:
        while True:
            items = self._drain()
            if not items:
                return
            t_start = time.perf_counter()
            xs = [x[0] if x.ndim == 4 else x for x, _, _ in items]
            n = len(xs)
            # bucket to the next power of two: one captured graph a bucket
            bucket = 1 << math.ceil(math.log2(max(n, 1)))
            batch = np.stack(xs + [xs[-1]] * (bucket - n))
            try:
                out = np.asarray(self.infer_fn(batch))
                t_done = time.perf_counter()
                infer_ms = (t_done - t_start) * 1e3
                for i, (_, t_enq, fut) in enumerate(items):
                    fut.set_result({
                        "probs": out[i],
                        "queue_ms": (t_start - t_enq) * 1e3,
                        "infer_ms": infer_ms,
                        "batch_size": n,
                    })
            except Exception as e:  # propagate to every waiter; the worker keeps serving
                for _, _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
