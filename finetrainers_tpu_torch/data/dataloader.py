"""Stateful dataloader (port of `finetrainers_tpu/data/dataloader.py`): one
data-parallel rank's share of a sample stream, by global round-robin index,
with a checkpointable position.

With `num_workers > 0` a background thread collates ahead of the consumer;
each queued batch carries the state snapshotted right after it was produced,
and `state_dict` gives the snapshot of the last batch handed out, not the
position the thread has read ahead to (the JAX loader reports the latter).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator


class DPDataLoader:
    def __init__(self, rank: int, dataset, batch_size: int = 1, num_workers: int = 0, collate_fn=None,
                 num_replicas: int = 1) -> None:
        self._rank = rank
        self._num_replicas = max(num_replicas, 1)
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.collate_fn = collate_fn or (lambda items: items)
        self._resume_skip = 0
        self._batches_yielded = 0
        # The global position in the sample stream: rank assignment is by global
        # index, and continues from the saved position on a resume.
        self._stream_index = 0
        self._consumed_state = None

    def _sample_iter(self) -> Iterator[Any]:
        for sample in self.dataset:
            i = self._stream_index
            self._stream_index += 1
            if i % self._num_replicas == self._rank:
                yield sample

    def _batch_iter(self) -> Iterator[Any]:
        batch = []
        for sample in self._sample_iter():
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []

    def __iter__(self) -> Iterator[Any]:
        it = self._batch_iter()
        for _ in range(self._resume_skip):  # a dataset without state replays from its start
            next(it, None)
        self._resume_skip = 0
        self._consumed_state = None
        if self.num_workers <= 0:
            for batch in it:
                self._batches_yielded += 1
                yield batch
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        done = object()

        def producer(produced):
            try:
                for batch in it:
                    produced += 1
                    q.put((batch, self._live_state(produced)))
            finally:
                q.put(done)

        threading.Thread(target=producer, args=(self._batches_yielded,), daemon=True).start()
        while (item := q.get()) is not done:
            batch, self._consumed_state = item
            self._batches_yielded += 1
            yield batch

    def _live_state(self, batches_yielded: int) -> Dict[str, Any]:
        state: Dict[str, Any] = {"batches_yielded": batches_yielded, "stream_index": self._stream_index}
        if hasattr(self.dataset, "state_dict"):
            state["dataset"] = self.dataset.state_dict()
        return {f"dp_rank_{self._rank}": state}

    def state_dict(self) -> Dict[str, Any]:
        if self._consumed_state is not None:
            return self._consumed_state
        return self._live_state(self._batches_yielded)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        my_state = state.get(f"dp_rank_{self._rank}", {})
        if "dataset" in my_state and hasattr(self.dataset, "load_state_dict"):
            self.dataset.load_state_dict(my_state["dataset"])
            self._stream_index = my_state.get("stream_index", 0)
        else:
            self._resume_skip = my_state.get("batches_yielded", 0)
            self._stream_index = 0
        self._batches_yielded = my_state.get("batches_yielded", 0)
        self._consumed_state = None
