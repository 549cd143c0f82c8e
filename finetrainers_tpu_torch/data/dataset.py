"""Streaming datasets with resumable state and resolution bucketing (port of
`finetrainers_tpu/data/dataset.py`).

Host-side numpy throughout, as in the JAX package: each dataset is a plain
iterable with the `state_dict`/`load_state_dict` resume contract
(`_sample_index`), tar webdatasets are read with the stdlib `tarfile`, and
decoded samples are bucketed to fixed shapes.

Beyond the copy:
- every processed sample carries a `sample_id` (its media path, or
  `<tar>:<key>` for a webdataset entry), which the trainer logs per step;
- `IterableCombinedDataset` saves where its shuffle buffer started, its
  random state and how much of the buffer it handed out, so a resume continues
  the same order (the JAX package restarts its shuffle and drops the rest of
  the buffer);
- a `None` media path in a validation row is no media (the JAX package tries
  to open it).

The Hub branch (`huggingface_hub`) and `.parquet` shards (`pyarrow`), and
`.parquet`/`.arrow` validation files (`pandas`), import their package when
used and raise a clear error where it is missing.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import random
import re
import tarfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import constants
from ..constants import COMMON_CAPTION_FILES, COMMON_IMAGE_FILES, COMMON_VIDEO_FILES
from ..functional.image import resize_crop_image, resize_to_nearest_bucket_image
from ..functional.text import convert_byte_str_to_str, remove_prefix
from ..functional.video import resize_crop_video, resize_to_nearest_bucket_video
from ..logging import get_logger
from .utils import _u8_hwc_to_float_chw, load_image, load_video


logger = get_logger(__name__)

MAX_PRECOMPUTABLE_ITEMS_LIMIT = 1024


def _optional_import(module: str, purpose: str):
    try:
        return importlib.import_module(module)
    except ImportError as err:
        package = module.split(".")[0]
        raise ImportError(f"{purpose} needs the `{package}` package, which is not installed") from err


class StatefulIterableDataset:
    """Base: an iterable with `_sample_index` resume."""

    def __init__(self, infinite: bool = False) -> None:
        self._infinite = infinite
        self._sample_index = 0
        self._precomputable_once = False

    def _samples(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self._samples())

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        samples = self._samples()
        if not samples:
            return
        while True:
            while self._sample_index < len(samples):
                idx = self._sample_index
                self._sample_index += 1
                yield dict(samples[idx])
            if not self._infinite:
                break
            self._sample_index = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"sample_index": self._sample_index}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._sample_index = state.get("sample_index", 0)


class ImageCaptionFilePairDataset(StatefulIterableDataset):
    """A directory of `x.png` + `x.txt` pairs."""

    media_key = "image"
    extensions = constants.SUPPORTED_IMAGE_FILE_EXTENSIONS

    def __init__(self, root: str, infinite: bool = False) -> None:
        super().__init__(infinite)
        self.root = pathlib.Path(root)
        data = []
        for ext in self.extensions:
            for media in sorted(self.root.glob(f"*.{ext}")):
                caption_file = media.with_suffix(".txt")
                if caption_file.exists():
                    data.append({"caption": caption_file.read_text().strip(), self.media_key: str(media)})
        self._data = data
        self._precomputable_once = len(data) <= MAX_PRECOMPUTABLE_ITEMS_LIMIT

    def _samples(self):
        return self._data


class VideoCaptionFilePairDataset(ImageCaptionFilePairDataset):
    media_key = "video"
    extensions = constants.SUPPORTED_VIDEO_FILE_EXTENSIONS


class ImageFileCaptionFileListDataset(StatefulIterableDataset):
    """`prompts.txt` + `images.txt` line-aligned lists."""

    media_key = "image"
    media_files = COMMON_IMAGE_FILES

    def __init__(self, root: str, infinite: bool = False) -> None:
        super().__init__(infinite)
        self.root = pathlib.Path(root)
        caption_file = next((self.root / f for f in COMMON_CAPTION_FILES if (self.root / f).exists()), None)
        media_file = next((self.root / f for f in self.media_files if (self.root / f).exists()), None)
        if caption_file is None or media_file is None:
            raise FileNotFoundError(f"Expected caption + media list files in {root}")
        captions = [line.strip() for line in caption_file.read_text().splitlines() if line.strip()]
        media = [line.strip() for line in media_file.read_text().splitlines() if line.strip()]
        if len(captions) != len(media):
            raise ValueError(f"Caption/media list length mismatch: {len(captions)} vs {len(media)}")
        self._data = [{"caption": c, self.media_key: str(self.root / m)} for c, m in zip(captions, media)]
        self._precomputable_once = len(self._data) <= MAX_PRECOMPUTABLE_ITEMS_LIMIT

    def _samples(self):
        return self._data


class VideoFileCaptionFileListDataset(ImageFileCaptionFileListDataset):
    media_key = "video"
    media_files = COMMON_VIDEO_FILES


class ImageFolderDataset(StatefulIterableDataset):
    """`metadata.{csv,jsonl,json}` beside the media files. A `control_image`
    (`control_video`) column names each sample's paired control file, which
    the control trainer takes as it is (the port's addition: JAX's folder
    datasets drop the column; ROADMAP.md section 3)."""

    media_key = "image"

    def __init__(self, root: str, infinite: bool = False) -> None:
        super().__init__(infinite)
        self.root = pathlib.Path(root)
        rows = _load_metadata(self.root)
        caption_col = next((c for c in constants.CAPTION_COLUMN_NAMES if c in rows[0]), None)
        file_col = next((c for c in ("file_name", "file", "path", "image", "video") if c in rows[0]), None)
        if caption_col is None or file_col is None:
            raise ValueError(f"metadata in {root} must contain caption + file_name columns; got {list(rows[0])}")
        control_col = "control_" + self.media_key
        self._data = [{"caption": r[caption_col], self.media_key: str(self.root / r[file_col]),
                       **({control_col: str(self.root / r[control_col])} if r.get(control_col) else {})}
                      for r in rows]
        self._precomputable_once = len(self._data) <= MAX_PRECOMPUTABLE_ITEMS_LIMIT

    def _samples(self):
        return self._data


class VideoFolderDataset(ImageFolderDataset):
    media_key = "video"


class ImageWebDataset(StatefulIterableDataset):
    """`.tar` shards whose entries pair `key.<media ext>` with `key.txt` or
    `key.json` (caption columns), or `.parquet` shards (with `pyarrow`).
    `caption_weights` picks among several caption columns at random."""

    media_key = "image"
    media_exts = constants.SUPPORTED_IMAGE_FILE_EXTENSIONS

    def __init__(self, root: str, infinite: bool = False, caption_weights: Optional[Dict[str, float]] = None) -> None:
        super().__init__(infinite)
        self.root = pathlib.Path(root)
        self.caption_weights = caption_weights or {}
        if self.root.is_dir():
            self._tars = sorted(self.root.glob("*.tar"))
            self._parquets = sorted(self.root.glob("*.parquet"))
        else:
            self._tars = [self.root] if self.root.suffix == ".tar" else []
            self._parquets = [self.root] if self.root.suffix == ".parquet" else []
        self._index: List[Tuple[str, Any]] = []  # (shard path, sample key | row index)
        for tar_path in self._tars:
            with tarfile.open(tar_path) as tf:
                keys: Dict[str, Dict[str, str]] = {}
                for member in tf.getmembers():
                    if member.isfile():
                        stem, _, ext = member.name.rpartition(".")
                        keys.setdefault(stem, {})[ext.lower()] = member.name
                for stem, entries in sorted(keys.items()):
                    if any(e in entries for e in self.media_exts):
                        self._index.append((str(tar_path), stem))
        if self._parquets:
            pq = _optional_import("pyarrow.parquet", "reading .parquet dataset shards")
            for pq_path in self._parquets:
                n_rows = pq.ParquetFile(pq_path).metadata.num_rows
                self._index.extend((str(pq_path), i) for i in range(n_rows))
        self._pq_cache: List[Any] = [None, None, None, (None, None)]
        self._precomputable_once = len(self._index) <= MAX_PRECOMPUTABLE_ITEMS_LIMIT

    def __len__(self) -> int:
        return len(self._index)

    def __iter__(self):
        if not self._index:
            return
        while True:
            while self._sample_index < len(self._index):
                shard, key = self._index[self._sample_index]
                self._sample_index += 1
                yield self._load(shard, key)
            if not self._infinite:
                break
            self._sample_index = 0

    def _choose_caption(self, caption_candidates: Dict[str, str]) -> Optional[str]:
        if not caption_candidates:
            return None
        cols = [c for c in caption_candidates if c in self.caption_weights]
        if cols:
            chosen = random.choices(cols, weights=[self.caption_weights[c] for c in cols], k=1)[0]
        else:
            chosen = next(iter(caption_candidates))
        return convert_byte_str_to_str(caption_candidates[chosen])

    def _load_parquet_row(self, pq_path: str, row_idx: int) -> Dict[str, Any]:
        """One row, keeping one decoded row group of the open file resident."""
        import bisect

        pq = _optional_import("pyarrow.parquet", "reading .parquet dataset shards")
        if self._pq_cache[0] != pq_path:
            pf = pq.ParquetFile(pq_path, memory_map=True)
            starts, off = [], 0
            for g in range(pf.metadata.num_row_groups):
                starts.append(off)
                off += pf.metadata.row_group(g).num_rows
            self._pq_cache = [pq_path, pf, starts, (None, None)]
        _, pf, starts, (group_idx, group_table) = self._pq_cache
        g = bisect.bisect_right(starts, row_idx) - 1
        if group_idx != g:
            group_table = pf.read_row_group(g)
            self._pq_cache[3] = (g, group_table)
        row = group_table.slice(row_idx - starts[g], 1).to_pylist()[0]
        sample: Dict[str, Any] = {"__key__": f"{pq_path}:{row_idx}"}
        caption_candidates: Dict[str, str] = {}
        for col, value in row.items():
            key = col.lower()
            payload, ext = None, None
            if isinstance(value, (bytes, bytearray)):
                payload = bytes(value)
                ext = key if key in self.media_exts else None
            elif isinstance(value, dict) and isinstance(value.get("bytes"), (bytes, bytearray)):
                payload = bytes(value["bytes"])
                ext = pathlib.Path(value.get("path") or "").suffix.lstrip(".").lower() or None
            if payload is not None and (key == self.media_key or ext in self.media_exts or key in self.media_exts):
                sample[self.media_key + "_bytes"] = payload
                sample[self.media_key + "_ext"] = ext or (key if key in self.media_exts else self.media_exts[0])
            elif isinstance(value, str) and (key in constants.CAPTION_COLUMN_NAMES or key == "txt"):
                caption_candidates[key] = value
        caption = self._choose_caption(caption_candidates)
        sample["caption"] = caption if caption is not None else ""
        return sample

    def _load(self, shard: str, stem) -> Dict[str, Any]:
        if shard.endswith(".parquet"):
            return self._load_parquet_row(shard, stem)
        with tarfile.open(shard) as tf:
            entries = {m.name.rpartition(".")[2].lower(): m for m in tf.getmembers()
                       if m.isfile() and m.name.rpartition(".")[0] == stem}
            sample: Dict[str, Any] = {"__key__": f"{shard}:{stem}"}
            caption_candidates: Dict[str, str] = {}
            for ext, member in entries.items():
                payload = tf.extractfile(member).read()
                if ext in self.media_exts:
                    sample[self.media_key + "_bytes"] = payload
                    sample[self.media_key + "_ext"] = ext
                elif ext == "txt":
                    caption_candidates["txt"] = payload.decode("utf-8", "replace")
                elif ext == "json":
                    meta = json.loads(payload)
                    for col in constants.CAPTION_COLUMN_NAMES:
                        if col in meta and isinstance(meta[col], str):
                            caption_candidates[col] = meta[col]
            caption = self._choose_caption(caption_candidates)
            sample["caption"] = caption if caption is not None else ""
            return sample


class VideoWebDataset(ImageWebDataset):
    media_key = "video"
    media_exts = constants.SUPPORTED_VIDEO_FILE_EXTENSIONS


class ValidationDataset:
    """A CSV/JSON/JSONL (or, with `pandas`, PARQUET/ARROW) file -> dicts, with
    `caption` renamed `prompt`, media paths loaded as uint8 frames, and the
    numeric fields of a CSV parsed."""

    def __init__(self, filename: str) -> None:
        path = pathlib.Path(filename)
        ext = path.suffix.lower()
        if ext == ".csv":
            import csv

            with open(path, newline="") as f:
                self.rows = [dict(r) for r in csv.DictReader(f)]
        elif ext == ".json":
            data = json.loads(path.read_text())
            self.rows = data["data"] if isinstance(data, dict) and "data" in data else data
        elif ext == ".jsonl":
            self.rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
        elif ext in (".parquet", ".arrow"):
            pd = _optional_import("pandas", "reading .parquet/.arrow validation files")
            df = pd.read_parquet(path) if ext == ".parquet" else pd.read_feather(path)
            self.rows = df.to_dict("records")
        else:
            raise ValueError(f"Unsupported validation dataset format: {ext}")

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for row in self.rows:
            out = dict(row)
            if "caption" in out and "prompt" not in out:
                out["prompt"] = out.pop("caption")
            for key in list(out):
                if out[key] in (None, ""):
                    continue
                if key in ("image_path", "control_image_path"):
                    out[key.replace("_path", "")] = load_image(out[key], to_float=False)
                elif key in ("video_path", "control_video_path"):
                    out[key.replace("_path", "")] = load_video(out[key], to_float=False)
            for key in ("height", "width", "num_frames", "num_inference_steps", "frame_rate"):
                if key in out and isinstance(out[key], str) and out[key].strip():
                    out[key] = int(float(out[key]))
            yield out

    def __len__(self) -> int:
        return len(self.rows)


class IterableDatasetPreprocessingWrapper:
    """Decode, bucket and clean captions.

    With `decode_workers > 0` the decode and resize run on an order-preserving
    thread pool: the stateful source is pulled serially, its state snapshotted
    as each raw sample is pulled, and `state_dict()` gives the snapshot of the
    last sample handed out, so a resume re-decodes what sat in the pool."""

    def __init__(
        self,
        dataset: StatefulIterableDataset,
        dataset_type: str,
        id_token: Optional[str] = None,
        image_resolution_buckets: Optional[List[Tuple[int, int]]] = None,
        video_resolution_buckets: Optional[List[Tuple[int, int, int]]] = None,
        reshape_mode: str = "bicubic",
        remove_common_llm_caption_prefixes: bool = False,
        rename_columns: Optional[Dict[str, str]] = None,
        decode_workers: int = 0,
        **kwargs,
    ) -> None:
        self.dataset = dataset
        self.dataset_type = dataset_type
        self.id_token = id_token
        self.image_resolution_buckets = image_resolution_buckets
        self.video_resolution_buckets = video_resolution_buckets
        self.reshape_mode = reshape_mode
        self.remove_common_llm_caption_prefixes = remove_common_llm_caption_prefixes
        self.rename_columns = rename_columns or {}
        self.decode_workers = decode_workers
        self._consumed_state: Optional[Dict[str, Any]] = None
        self._precomputable_once = getattr(dataset, "_precomputable_once", False)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.decode_workers > 0 and hasattr(self.dataset, "state_dict"):
            yield from self._iter_parallel()
            return
        for sample in self.dataset:
            out = self._process(sample)
            if out is not None:
                yield out

    def _iter_parallel(self) -> Iterator[Dict[str, Any]]:
        import collections
        from concurrent.futures import ThreadPoolExecutor

        it = iter(self.dataset)
        pending: "collections.deque" = collections.deque()
        with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:

            def pull() -> bool:
                try:
                    raw = next(it)
                except StopIteration:
                    return False
                pending.append((pool.submit(self._process, raw), self.dataset.state_dict()))
                return True

            for _ in range(self.decode_workers + 2):
                if not pull():
                    break
            while pending:
                fut, snap = pending.popleft()
                pull()
                out = fut.result()
                self._consumed_state = snap  # published before the yield
                if out is not None:
                    yield out

    def _process(self, sample: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if self.rename_columns:
            sample = {self.rename_columns.get(k, k): v for k, v in sample.items()}
        caption = sample.get("caption", "")
        if self.remove_common_llm_caption_prefixes:
            caption = remove_prefix(caption, constants.COMMON_LLM_START_PHRASES)
        if self.id_token:
            caption = f"{self.id_token} {caption}"
        media_key = "image" if self.dataset_type == "image" else "video"
        source = sample.get(media_key)
        out: Dict[str, Any] = {"caption": caption,
                               "sample_id": source if isinstance(source, str) else sample.get("__key__")}
        try:
            if self.dataset_type == "image":
                image = self._decode_image(sample)
                if self.image_resolution_buckets:
                    image = resize_to_nearest_bucket_image(image, self.image_resolution_buckets, self.reshape_mode)
                out["image"] = np.ascontiguousarray(image)
                if "control_image" in sample or "control_image_bytes" in sample:
                    ctrl = self._decode_image(sample, "control_image")
                    out["control_image"] = np.ascontiguousarray(resize_crop_image(ctrl, image.shape[-2:]))
            else:
                video = self._decode_video(sample)
                if self.video_resolution_buckets:
                    video, first_frame_only = resize_to_nearest_bucket_video(
                        video, self.video_resolution_buckets, self.reshape_mode)
                    if first_frame_only:
                        video = video[:1]
                out["video"] = np.ascontiguousarray(video)
                if "control_video" in sample or "control_video_bytes" in sample:
                    ctrl = resize_crop_video(self._decode_video(sample, "control_video"), video.shape[-2:])
                    out["control_video"] = np.ascontiguousarray(ctrl[: video.shape[0]])
        except (FileNotFoundError, ValueError) as e:
            logger.warning(f"Skipping sample: {e}")
            return None
        return out

    def _decode_image(self, sample, key: str = "image") -> np.ndarray:
        if f"{key}_bytes" in sample:
            import cv2

            buf = np.frombuffer(sample[f"{key}_bytes"], np.uint8)
            return _u8_hwc_to_float_chw(cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
        value = sample[key]
        return value if isinstance(value, np.ndarray) else load_image(value)

    def _decode_video(self, sample, key: str = "video") -> np.ndarray:
        if f"{key}_bytes" in sample:
            import tempfile

            with tempfile.NamedTemporaryFile(suffix="." + sample.get(f"{key}_ext", "mp4")) as f:
                f.write(sample[f"{key}_bytes"])
                f.flush()
                return load_video(f.name)
        value = sample[key]
        return value if isinstance(value, np.ndarray) else load_video(value)

    def state_dict(self):
        if self._consumed_state is not None:
            return self._consumed_state
        return self.dataset.state_dict()

    def load_state_dict(self, state):
        self.dataset.load_state_dict(state)
        self._consumed_state = None


class IterableCombinedDataset:
    """Round-robin buffered combination of datasets, shuffled per buffer with a
    seeded `random.Random` when `shuffle` (the same order as the JAX package's).

    `state_dict` holds the datasets' states and the random state from where the
    current buffer began filling, and how many of its items were handed out:
    `load_state_dict` refills that buffer, shuffles it the same way and skips
    those items, so the order after a resume is the unbroken run's."""

    def __init__(self, datasets: List[Any], buffer_size: int = 1, shuffle: bool = False, seed: int = 0) -> None:
        self.datasets = datasets
        self.buffer_size = max(buffer_size, 1)
        self.shuffle = shuffle
        self._rng = random.Random(seed)
        self._precomputable_once = all(getattr(d, "_precomputable_once", False) for d in datasets)
        self._buffer_start: Optional[Dict[str, Any]] = None
        self._buffer_yielded = 0
        self._skip = 0

    def _start_state(self) -> Dict[str, Any]:
        version, internal, gauss = self._rng.getstate()
        return {"datasets": [d.state_dict() for d in self.datasets], "rng": [version, list(internal), gauss]}

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        iterators = [iter(d) for d in self.datasets]
        buffer: List[Dict[str, Any]] = []
        active = list(range(len(iterators)))
        skip, self._skip = self._skip, 0
        start = None
        while active:
            if not buffer:
                start = self._start_state()
            for idx in list(active):
                try:
                    buffer.append(next(iterators[idx]))
                except StopIteration:
                    active.remove(idx)
            if len(buffer) >= self.buffer_size or not active:
                if self.shuffle:
                    self._rng.shuffle(buffer)
                for i, item in enumerate(buffer):
                    if i < skip:
                        continue
                    self._buffer_start, self._buffer_yielded = start, i + 1
                    yield item
                skip, buffer = 0, []

    def state_dict(self) -> Dict[str, Any]:
        if self._buffer_start is None:
            return {**self._start_state(), "buffer_yielded": 0}
        return {**self._buffer_start, "buffer_yielded": self._buffer_yielded}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for d, s in zip(self.datasets, state.get("datasets", [])):
            d.load_state_dict(s)
        if "rng" in state:
            version, internal, gauss = state["rng"]
            self._rng.setstate((version, tuple(internal), gauss))
        self._skip = state.get("buffer_yielded", 0)
        self._buffer_start, self._buffer_yielded = None, 0


# ------------------------------------------------------------------ detection


def initialize_dataset(dataset_name_or_root: str, dataset_type: str = "video", streaming: bool = True,
                       infinite: bool = False, caption_options: Optional[Dict[str, Any]] = None):
    """Detect the layout of a local dataset (or a Hub id, with `huggingface_hub`)."""
    root = pathlib.Path(dataset_name_or_root)
    if not root.exists():
        if re.fullmatch(r"[\w][\w.\-]*/[\w][\w.\-]*", dataset_name_or_root) is not None:
            return _initialize_hub_dataset(dataset_name_or_root, dataset_type, infinite, caption_options)
        raise FileNotFoundError(f"{dataset_name_or_root} does not exist locally and is not a hub dataset id")
    image = dataset_type == "image"
    if root.is_file() and root.suffix in (".tar", ".parquet"):
        return (ImageWebDataset if image else VideoWebDataset)(str(root), infinite=infinite, **(caption_options or {}))
    return _detect_layout(root, image, infinite, caption_options,
                          has=lambda name: (root / name).exists(),
                          has_shards=bool(list(root.glob("*.tar")) or list(root.glob("*.parquet"))))


def _detect_layout(root, image: bool, infinite: bool, caption_options, has, has_shards: bool):
    if any(has(m) for m in ("metadata.json", "metadata.jsonl", "metadata.csv")):
        return (ImageFolderDataset if image else VideoFolderDataset)(str(root), infinite=infinite)
    if has_shards:
        return (ImageWebDataset if image else VideoWebDataset)(str(root), infinite=infinite, **(caption_options or {}))
    if any(has(f) for f in COMMON_CAPTION_FILES) and (
            any(has(f) for f in COMMON_VIDEO_FILES) or any(has(f) for f in COMMON_IMAGE_FILES)):
        return (ImageFileCaptionFileListDataset if image else VideoFileCaptionFileListDataset)(str(root), infinite=infinite)
    ds = (ImageCaptionFilePairDataset if image else VideoCaptionFilePairDataset)(str(root), infinite=infinite)
    if len(ds) == 0:
        raise ValueError(f"Could not detect a supported dataset layout under {root}")
    return ds


def _initialize_hub_dataset(repo_id: str, dataset_type: str, infinite: bool, caption_options):
    """The Hub branch: list the repo's files, download it, and detect the layout
    of the local copy. Needs `huggingface_hub` and the network."""
    hub = _optional_import("huggingface_hub", f"the Hub dataset {repo_id!r}")
    files = hub.list_repo_files(repo_id, repo_type="dataset")
    has_shards = any(f.endswith((".tar", ".parquet")) for f in files)
    patterns = ["*.tar", "*.parquet"] if has_shards and not any(
        m in files for m in ("metadata.json", "metadata.jsonl", "metadata.csv")) else None
    root = hub.snapshot_download(repo_id, repo_type="dataset", allow_patterns=patterns)
    return _detect_layout(pathlib.Path(root), dataset_type == "image", infinite, caption_options,
                          has=lambda name: name in files, has_shards=has_shards)


def combine_datasets(datasets: List[Any], buffer_size: int = 1, shuffle: bool = False) -> Any:
    if len(datasets) == 1 and buffer_size <= 1 and not shuffle:
        return datasets[0]
    return IterableCombinedDataset(datasets, buffer_size=buffer_size, shuffle=shuffle)


def wrap_iterable_dataset_for_preprocessing(dataset, dataset_type: str, config: Dict[str, Any]):
    return IterableDatasetPreprocessingWrapper(dataset, dataset_type, **config)


def _load_metadata(root: pathlib.Path) -> List[Dict[str, Any]]:
    if (root / "metadata.csv").exists():
        import csv

        with open(root / "metadata.csv", newline="") as f:
            return [dict(r) for r in csv.DictReader(f)]
    if (root / "metadata.jsonl").exists():
        return [json.loads(line) for line in (root / "metadata.jsonl").read_text().splitlines() if line.strip()]
    if (root / "metadata.json").exists():
        data = json.loads((root / "metadata.json").read_text())
        return data if isinstance(data, list) else data["data"]
    raise FileNotFoundError(f"No metadata file in {root}")
