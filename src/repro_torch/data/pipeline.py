"""Host-side data pipeline: background prefetch + device placement.

The port of ``repro.data.pipeline``.  :func:`shard_batch` puts each numpy
batch on the step's device: through pinned host memory and a
``non_blocking`` copy on CUDA, so the copy of batch n + 1 overlaps step n.
On a mesh, :func:`repro_torch.distributed.sharding.place` then lays it
out by its batch axes, as the
reference places it with the step's batch sharding: every rank draws the
same seeded batch (the reference's single controller draws it once) and
keeps its shard, so nothing is sent.  The worker places a batch holding
:data:`repro_torch.runtime.jit.CAPTURE_LOCK`, so a compiled step's capture
never runs beside it.  The consumer's wait for a batch is the span
``data.wait`` (:data:`repro_torch.obs.TRACER`).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import place
from repro_torch.obs.trace import TRACER
from repro_torch.runtime.jit import CAPTURE_LOCK

#: what the worker puts at the end of its source
_END = object()
#: seconds ``close`` waits for the worker (it exits within one put)
_JOIN_SECONDS = 5.0


def shard_batch(batch: Dict[str, np.ndarray],
                device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


class DataPipeline:
    """Iterator wrapper with a daemon prefetch thread (depth-N queue).

    An exception raised while the worker reads or places a batch reaches the
    consumer at the batch it would have been; the end of the source ends
    the iteration."""

    def __init__(self, source: Iterator, device: Union[str, torch.device],
                 prefetch: int = 2, *, axes: Optional[Dict[str, tuple]] = None,
                 rules: Any = None, mesh: Any = None):
        self._source = source
        self._device = device
        self._axes, self._rules, self._mesh = axes, rules, mesh
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless the pipeline is closed first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self._source:
                with CAPTURE_LOCK:      # no device work while a step is captured
                    batch = shard_batch(item, self._device)
                    if self._mesh is not None:
                        batch = place(batch, self._axes, self._rules, self._mesh)
                if self._stop.is_set() or not self._put(batch):
                    return
        except Exception as e:          # surface worker errors to the consumer
            self._put(e)
            return
        self._put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        with TRACER.span("data.wait"):
            item = self._q.get()
        if item is _END:
            self._q.put(_END)
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        """Stop the worker and wait for it."""
        self._stop.set()
        self._thread.join(_JOIN_SECONDS)
