"""Resolution-bucket batch sampler (copied from `finetrainers_tpu/data/sampler.py`).

Consumes (condition, latent) dict pairs, buckets them by the shape of the
leader tensor (the spec's `_resolution_dim_keys`), and emits a batch when a
bucket fills, so every batch has one shape."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class ResolutionSampler:
    def __init__(self, batch_size: int, dim_keys: Dict[str, Tuple[int, ...]]) -> None:
        self.batch_size = batch_size
        self.dim_keys = dim_keys
        self._buckets: Dict[Tuple, List[Tuple[Dict, Dict]]] = {}

    def consume(self, conditions: Dict[str, Any], latents: Dict[str, Any]) -> None:
        leader_key = next(iter(self.dim_keys))
        shape = latents[leader_key].shape
        bucket = tuple(shape[d] for d in self.dim_keys[leader_key])
        self._buckets.setdefault(bucket, []).append((conditions, latents))

    @property
    def ready(self) -> bool:
        return any(len(v) >= self.batch_size for v in self._buckets.values())

    def get_batch(self) -> Tuple[List[Dict], List[Dict]]:
        for bucket, items in self._buckets.items():
            if len(items) >= self.batch_size:
                batch, self._buckets[bucket] = items[: self.batch_size], items[self.batch_size:]
                return [c for c, _ in batch], [lat for _, lat in batch]
        raise RuntimeError("No bucket is full; check `ready` first")
