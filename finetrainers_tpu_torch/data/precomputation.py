"""Condition and latent precomputation (port of
`finetrainers_tpu/data/precomputation.py`).

`initialize_preprocessor` picks the in-memory buffer or the on-disk
directory; `consume` processes `num_items` samples into an iterable that asks
for a refill after its last item (`requires_data`), `consume_once` into one
that cycles them forever. On disk each item is one `np.savez` file,
`{save_dir}/finetrainers-precomputed-data/{data_type}-{rank * num_items + i}.npz`,
the JAX package's names and format, so either package reads the other's
directory. Tensors (a VAE's moments on the card) are copied to the host to be
saved; the in-memory buffer keeps items as the processor returned them.
"""

from __future__ import annotations

import pathlib
from typing import Any, Callable, Dict, Iterator, List

import numpy as np
import torch

from ..constants import PRECOMPUTED_DIR_NAME
from ..logging import get_logger


logger = get_logger(__name__)


def initialize_preprocessor(rank: int, num_items: int, processor_fn: Dict[str, Callable[..., Dict[str, Any]]],
                            save_dir: str = None, enable_precomputation: bool = False):
    if enable_precomputation:
        return PrecomputedDistributedDataPreprocessor(rank, num_items, processor_fn, save_dir)
    return InMemoryDistributedDataPreprocessor(rank, num_items, processor_fn)


class BasePreprocessor:
    def __init__(self, rank: int, num_items: int, processor_fn: Dict[str, Callable]) -> None:
        self._rank = rank
        self._num_items = num_items
        self._processor_fn = processor_fn
        self._cached_samples: List[Dict[str, Any]] = []
        self._preprocessed_iterator = None

    def _process(self, data_type: str, data_iterator, cache_samples: bool, use_cached_samples: bool,
                 drop_samples: bool, components: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        """`num_items` processed items: the next samples of `data_iterator`
        (kept for the other data type with `cache_samples`), or the kept ones."""
        fn = self._processor_fn[data_type]
        for i in range(self._num_items):
            if use_cached_samples:
                sample = self._cached_samples[i]
            else:
                sample = next(data_iterator)
                if cache_samples:
                    self._cached_samples.append(sample)
            yield fn(**sample, **components)
        if drop_samples:
            self._cached_samples = []

    @property
    def requires_data(self) -> bool:
        """True before the first round and once the live iterable has handed out
        its last item; a cycling iterable never requires data."""
        it = self._preprocessed_iterator
        return True if it is None else it.requires_data


class InMemoryDataBuffer:
    """FIFO buffers by data type, with an optional size limit."""

    def __init__(self, max_limit: int = -1) -> None:
        self.max_limit = max_limit
        self._buffers: Dict[str, List[Any]] = {}

    def add(self, data_type: str, item: Any) -> None:
        buf = self._buffers.setdefault(data_type, [])
        if 0 <= self.max_limit <= len(buf):
            buf.pop(0)
        buf.append(item)

    def get(self, data_type: str) -> Any:
        return self._buffers[data_type].pop(0)

    def size(self, data_type: str) -> int:
        return len(self._buffers.get(data_type, []))


class InMemoryDistributedDataPreprocessor(BasePreprocessor):
    def __init__(self, rank, num_items, processor_fn) -> None:
        super().__init__(rank, num_items, processor_fn)
        self._buffer = InMemoryDataBuffer()

    def consume(self, data_type: str, data_iterator, cache_samples: bool = False, use_cached_samples: bool = False,
                drop_samples: bool = False, **components) -> "InMemoryDataIterable":
        for item in self._process(data_type, data_iterator, cache_samples, use_cached_samples, drop_samples,
                                  components):
            self._buffer.add(data_type, item)
        self._preprocessed_iterator = InMemoryDataIterable(self._rank, data_type, self._buffer)
        return self._preprocessed_iterator

    def consume_once(self, data_type: str, data_iterator, cache_samples: bool = False,
                     use_cached_samples: bool = False, drop_samples: bool = False,
                     **components) -> "InMemoryOnceDataIterable":
        self.consume(data_type, data_iterator, cache_samples, use_cached_samples, drop_samples, **components)
        self._preprocessed_iterator = InMemoryOnceDataIterable(self._rank, data_type, self._buffer)
        return self._preprocessed_iterator


class InMemoryDataIterable:
    """Yields until the buffer drains; requires data once its last item is out."""

    def __init__(self, rank: int, data_type: str, buffer: InMemoryDataBuffer) -> None:
        self._rank = rank
        self._data_type = data_type
        self._buffer = buffer
        self._requires_data = False

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while self._buffer.size(self._data_type) > 0:
            if self._buffer.size(self._data_type) == 1:
                self._requires_data = True
            yield self._buffer.get(self._data_type)

    def __len__(self) -> int:
        return self._buffer.size(self._data_type)

    @property
    def requires_data(self) -> bool:
        return self._requires_data


class InMemoryOnceDataIterable(InMemoryDataIterable):
    """Cycles the buffer forever, each popped item appended again."""

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        assert self._buffer.size(self._data_type) > 0
        while True:
            item = self._buffer.get(self._data_type)
            self._buffer.add(self._data_type, item)
            yield item

    @property
    def requires_data(self) -> bool:
        return False


class PrecomputedDistributedDataPreprocessor(BasePreprocessor):
    """Saves each processed item as an `.npz` under
    `{save_dir}/finetrainers-precomputed-data` and reads it back."""

    def __init__(self, rank, num_items, processor_fn, save_dir: str) -> None:
        super().__init__(rank, num_items, processor_fn)
        self._save_dir = pathlib.Path(save_dir) / PRECOMPUTED_DIR_NAME
        self._save_dir.mkdir(parents=True, exist_ok=True)

    def consume(self, data_type: str, data_iterator, cache_samples: bool = False, use_cached_samples: bool = False,
                drop_samples: bool = False, **components) -> "PrecomputedDataIterable":
        for i, item in enumerate(self._process(data_type, data_iterator, cache_samples, use_cached_samples,
                                               drop_samples, components)):
            np.savez(self._save_dir / f"{data_type}-{self._rank * self._num_items + i}.npz", **_only_arrays(item))
        self._preprocessed_iterator = PrecomputedDataIterable(self._rank, self._num_items, data_type,
                                                              str(self._save_dir))
        return self._preprocessed_iterator

    def consume_once(self, data_type: str, data_iterator, **kwargs) -> "PrecomputedOnceDataIterable":
        self.consume(data_type, data_iterator, **kwargs)
        self._preprocessed_iterator = PrecomputedOnceDataIterable(self._rank, self._num_items, data_type,
                                                                  str(self._save_dir))
        return self._preprocessed_iterator

    @classmethod
    def load_existing(cls, rank: int, num_items: int, save_dir: str, data_type: str):
        """A cycling iterable over a directory precomputed earlier (by either package)."""
        root = pathlib.Path(save_dir) / PRECOMPUTED_DIR_NAME
        missing = [p for p in (root / f"{data_type}-{rank * num_items + i}.npz" for i in range(num_items))
                   if not p.exists()]
        if missing:
            raise FileNotFoundError(f"Precomputed data missing {len(missing)} files, e.g. {missing[0]}")
        return PrecomputedOnceDataIterable(rank, num_items, data_type, str(root))


class PrecomputedDataIterable:
    def __init__(self, rank: int, num_items: int, data_type: str, save_dir: str) -> None:
        root = pathlib.Path(save_dir)
        self._root = root if root.name == PRECOMPUTED_DIR_NAME else root / PRECOMPUTED_DIR_NAME
        self._rank = rank
        self._num_items = num_items
        self._data_type = data_type
        self._requires_data = False

    def _load(self, i: int) -> Dict[str, Any]:
        with np.load(self._root / f"{self._data_type}-{self._rank * self._num_items + i}.npz", allow_pickle=True) as z:
            return {k: z[k] for k in z.files}

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(self._num_items):
            if i == self._num_items - 1:
                self._requires_data = True
            yield self._load(i)

    def __len__(self) -> int:
        return self._num_items

    @property
    def requires_data(self) -> bool:
        return self._requires_data


class PrecomputedOnceDataIterable(PrecomputedDataIterable):
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        while True:
            for i in range(self._num_items):
                yield self._load(i)

    @property
    def requires_data(self) -> bool:
        return False


def _only_arrays(d: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The item's arrays as numpy (tensors copied to the host); other values dropped."""
    out = {}
    for k, v in d.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
            continue
        try:
            out[k] = np.asarray(v)
        except Exception:
            logger.debug(f"Dropping non-array key {k} from precomputed sample")
    return out
