"""Device prefetch (port of `finetrainers_tpu/data/prefetch.py`).

A background thread runs the train loop's host work for the next batches
(decode, precompute refills, collation) and copies each batch to the card:
into pinned host memory, then `non_blocking=True` on a stream of its own,
with an event the consumer's stream waits on. Up to `depth` batches queue
ahead of the consumer.

Each queued batch carries the loader snapshot taken right after it was
produced; `consumed_state` is the snapshot of the last batch handed to the
trainer, which is what a checkpoint saves (the live loader has read ahead).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


def to_device(tree: Any, device: torch.device, pin: bool = False, non_blocking: bool = False) -> Any:
    """numpy arrays and tensors of a nested dict/list/tuple on `device`; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, pin, non_blocking) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device, pin, non_blocking) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind in "biuf":
        tree = torch.from_numpy(tree)
    elif not isinstance(tree, torch.Tensor):
        return tree
    if tree.device == device:
        return tree
    if pin and tree.device.type == "cpu":
        tree = tree.pin_memory()
    return tree.to(device, non_blocking=non_blocking)


def _tensors(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class DevicePrefetcher:
    def __init__(self, source: Iterator[Any], device: torch.device, depth: int = 2,
                 snapshot_fn: Optional[Callable[[], Any]] = None) -> None:
        self._source = source
        self._device = torch.device(device)
        self._snapshot_fn = snapshot_fn or (lambda: None)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._done = False
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        #: the loader state as of the last batch returned by __next__.
        self.consumed_state: Any = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for batch in self._source:
                snapshot, event = self._snapshot_fn(), None
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        batch = to_device(batch, self._device, pin=True, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._stream)
                else:
                    batch = to_device(batch, self._device)
                if not self._put((snapshot, batch, event)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._put(_SENTINEL)

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        snapshot, batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(batch):  # the copy stream's memory stays live until the consumer's work on it ends
                t.record_stream(stream)
        self.consumed_state = snapshot
        return batch

    def stop(self) -> None:
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60)


_SENTINEL = object()
