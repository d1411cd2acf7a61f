"""Prefetching host→device loader.

Port of ``repro/data/loader.py``. One background thread keeps ``prefetch``
batches ahead of the training loop (generation and the host-to-device copy
overlap the previous step's compute). The iterator is index-based and
restartable: ``Loader(fn, start_index=s)`` resumes the exact stream after a
checkpoint restore. The default ``put_fn`` turns a numpy batch (an array or
a dict of arrays) into tensors on ``device``: through pinned host memory
and a ``non_blocking`` copy on a card, as they are on the CPU.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.types import resolve_device


def to_device(batch, device: torch.device):
    """A numpy array, or a dict of them, as tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    host = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class Loader:
    def __init__(
        self,
        batch_fn: Callable[[int], Any],
        *,
        device: str | torch.device = "cuda",
        start_index: int = 0,
        prefetch: int = 2,
        put_fn: Callable[[Any], Any] | None = None,
    ):
        self._batch_fn = batch_fn
        if put_fn is None:
            dev = resolve_device(device)
            put_fn = lambda b: to_device(b, dev)  # noqa: E731
        self._put = put_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._index = start_index
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        i = self._index
        while not self._stop.is_set():
            try:
                batch = self._put(self._batch_fn(i))
            except Exception as e:  # handed to the consumer, raised by __next__
                self._q.put(e)
                return
            self._q.put((i, batch))
            i += 1

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item  # (index, device_batch)

    def close(self) -> None:
        self._stop.set()
        # drain so the worker's blocking put releases
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60)
