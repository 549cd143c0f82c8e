"""The port's datasets, loader, sampler and precompute against the JAX package's.

On media the test writes into `tmp_path`:

- each local layout `initialize_dataset` detects (a folder with
  metadata.csv/.json/.jsonl, caption and video file lists, caption-file pairs,
  a `.tar` webdataset) yields the same samples in the same order as JAX's,
  and its `state_dict` round trip resumes at the same sample;
- `IterableCombinedDataset` with a seeded shuffle buffer gives JAX's order;
  its state taken anywhere, loaded into a fresh dataset, continues that order
  (the JAX dataset restarts its shuffle there); each package reads the
  other's state;
- `DPDataLoader`'s state equals JAX's, with and without its thread, and a
  resume continues at the same batch; the resolution sampler buckets alike;
- `ValidationDataset` reads the example's validation.json (a `null` media
  path is no media) and a CSV as JAX reads the CSV;
- `.npz` items precomputed by one package are read by the other, both ways;
- `DevicePrefetcher` on the CPU hands out batches in order with the snapshot
  taken after each, and re-raises the source's error.
"""

import csv
import io
import json
import pathlib
import tarfile

import cv2
import numpy as np
import pytest
import torch

from finetrainers_tpu import data as jax_data
from finetrainers_tpu_torch import data
from finetrainers_tpu_torch.data import precomputation

REPO = pathlib.Path(__file__).resolve().parents[1]


def _write_video(path, seed, frames=4, size=(24, 16)):
    rng = np.random.RandomState(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, size)
    for _ in range(frames):
        writer.write((rng.rand(size[1], size[0], 3) * 255).astype(np.uint8))
    writer.release()


def _layout(root, kind):
    root.mkdir()
    captions = [f"caption {i}" for i in range(3)]
    for i in range(3):
        _write_video(root / f"v{i}.mp4", i)
    if kind.startswith("metadata"):
        rows = [{"file_name": f"v{i}.mp4", "caption": c} for i, c in enumerate(captions)]
        if kind == "metadata.csv":
            with open(root / kind, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
                w.writeheader()
                w.writerows(rows)
        elif kind == "metadata.json":
            (root / kind).write_text(json.dumps(rows))
        else:
            (root / kind).write_text("\n".join(json.dumps(r) for r in rows))
    elif kind == "lists":
        (root / "prompts.txt").write_text("\n".join(captions))
        (root / "videos.txt").write_text("\n".join(f"v{i}.mp4" for i in range(3)))
    elif kind == "pairs":
        for i, c in enumerate(captions):
            (root / f"v{i}.txt").write_text(c)
    elif kind == "tar":
        with tarfile.open(root / "shard.tar", "w") as tf:
            for i, c in enumerate(captions):
                tf.add(root / f"v{i}.mp4", arcname=f"s{i}.mp4")
                payload = (json.dumps({"caption": c}) if i % 2 else c).encode()
                info = tarfile.TarInfo(f"s{i}.{'json' if i % 2 else 'txt'}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return root


def _strip(sample):
    return {k: v for k, v in sample.items() if k != "__key__"}


@pytest.mark.parametrize("kind", ["metadata.csv", "metadata.json", "metadata.jsonl", "lists", "pairs", "tar"])
def test_each_layout_yields_jax_samples(tmp_path, kind):
    root = _layout(tmp_path / "ds", kind)
    ours = data.initialize_dataset(str(root), "video", infinite=True)
    ref = jax_data.initialize_dataset(str(root), "video", infinite=True)
    assert type(ours).__name__ == type(ref).__name__ and len(ours) == len(ref) == 3
    ours_it, ref_it = iter(ours), iter(ref)
    for _ in range(5):  # past the end: the infinite datasets wrap around
        assert _strip(next(ours_it)) == next(ref_it)
    state = ours.state_dict()
    assert state == ref.state_dict()
    fresh = data.initialize_dataset(str(root), "video", infinite=True)
    fresh.load_state_dict(state)
    assert _strip(next(iter(fresh))) == next(ref_it)
    wrapped = list(data.IterableDatasetPreprocessingWrapper(data.initialize_dataset(str(root), "video"), "video"))
    assert [w["caption"] for w in wrapped] == [f"caption {i}" for i in range(3)]
    assert all(w["video"].shape == (4, 3, 16, 24) and w["sample_id"] for w in wrapped)


class _Counter:
    """A stateful stream of numbered samples."""

    def __init__(self, n, infinite=True, base=0):
        self.n, self.infinite, self.base, self._i = n, infinite, base, 0

    def __iter__(self):
        while True:
            while self._i < self.n:
                self._i += 1
                yield {"id": self.base + self._i - 1}
            if not self.infinite:
                return
            self._i = 0

    def state_dict(self):
        return {"sample_index": self._i}

    def load_state_dict(self, state):
        self._i = state.get("sample_index", 0)


def _take(it, n):
    return [next(it)["id"] for _ in range(n)]


@pytest.mark.parametrize("at", [0, 3, 10, 17])
def test_combined_shuffle_order_and_exact_resume(at):
    ours = data.IterableCombinedDataset([_Counter(4), _Counter(3)], buffer_size=10, shuffle=True)
    ref = jax_data.IterableCombinedDataset([_Counter(4), _Counter(3)], buffer_size=10, shuffle=True)
    unbroken = _take(iter(ref), 40)
    assert _take(iter(ours), 40) == unbroken
    broken = data.IterableCombinedDataset([_Counter(4), _Counter(3)], buffer_size=10, shuffle=True)
    it = iter(broken)
    head = _take(it, at)
    state = json.loads(json.dumps(broken.state_dict()))  # it survives a JSON round trip
    resumed = data.IterableCombinedDataset([_Counter(4), _Counter(3)], buffer_size=10, shuffle=True)
    resumed.load_state_dict(state)
    assert head + _take(iter(resumed), 40 - at) == unbroken


def test_combined_state_is_read_across_packages():
    """JAX's dataset reads the port's state (its extra keys aside) and resumes
    at the start of the port's current buffer, so nothing is skipped; the port
    reads JAX's state as JAX itself does."""
    def make(pkg):
        return pkg.IterableCombinedDataset([_Counter(5), _Counter(2, base=100)], buffer_size=3)

    unbroken = _take(iter(make(jax_data)), 16)
    ours = make(data)
    head = _take(iter(ours), 5)  # buffers fill two items a round: the second (items 4-7) is partly handed out
    jax_resumed = make(jax_data)
    jax_resumed.load_state_dict(ours.state_dict())
    assert head == unbroken[:5] and _take(iter(jax_resumed), 8) == unbroken[4:12]
    ref = make(jax_data)
    ref_it = iter(ref)
    _take(ref_it, 4)
    from_jax, jax_again = make(data), make(jax_data)
    from_jax.load_state_dict(ref.state_dict())
    jax_again.load_state_dict(ref.state_dict())
    assert _take(iter(from_jax), 8) == _take(iter(jax_again), 8)


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_state_and_resume_equal_jax(workers):
    def loaders():
        return (data.DPDataLoader(0, _Counter(5), batch_size=2, num_workers=workers),
                jax_data.DPDataLoader(0, _Counter(5), batch_size=2, num_workers=0))

    ours, ref = loaders()
    a, b = iter(ours), iter(ref)
    for _ in range(3):
        assert next(a) == next(b)
    assert ours.state_dict() == ref.state_dict()  # with a thread: the batch handed out, not the read-ahead
    resumed, _ = loaders()
    resumed.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert [next(iter(resumed)) for _ in range(1)] == [next(b)]


def test_resolution_sampler_equals_jax():
    keys = {"latents": (2, 3, 4)}
    ours, ref = data.ResolutionSampler(2, keys), jax_data.ResolutionSampler(2, keys)
    shapes = [(1, 8, 2, 4, 4), (1, 8, 2, 4, 6), (1, 8, 2, 4, 4), (1, 8, 2, 4, 6)]
    for i, shape in enumerate(shapes):
        for s in (ours, ref):
            s.consume({"i": i}, {"latents": np.zeros(shape)})
        assert ours.ready == ref.ready
        if ours.ready:
            assert ours.get_batch()[0] == ref.get_batch()[0]


def test_validation_dataset_reads_the_example_and_csv(tmp_path):
    example = REPO / "examples" / "training" / "sft" / "wan" / "crush_smol_lora" / "validation.json"
    rows = list(data.ValidationDataset(str(example)))
    assert rows and rows[0]["prompt"].startswith("PIKA_CRUSH") and "image" not in rows[0] and rows[0]["height"] == 480
    _write_video(tmp_path / "v.mp4", 3)
    with open(tmp_path / "val.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["caption", "video_path", "num_frames", "height"])
        w.writeheader()
        w.writerow({"caption": "a clip", "video_path": str(tmp_path / "v.mp4"), "num_frames": "4", "height": "16"})
    ours, ref = list(data.ValidationDataset(str(tmp_path / "val.csv"))), list(
        jax_data.ValidationDataset(str(tmp_path / "val.csv")))
    assert ours[0].keys() == ref[0].keys() and ours[0]["num_frames"] == ref[0]["num_frames"] == 4
    assert np.array_equal(ours[0]["video"], ref[0]["video"])


def _items(n):
    rng = np.random.RandomState(4)
    return [{"latents": rng.randn(1, 4, 2, 3, 3).astype(np.float32), "latents_mean": np.zeros(2, np.float32),
             "mask": np.ones((1, 5), np.int32)} for _ in range(n)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_precomputed_npz_read_across_packages(tmp_path, writer):
    items = _items(3)
    samples = iter([{"i": i} for i in range(3)])
    make = precomputation.initialize_preprocessor if writer == "port" else jax_data.initialize_preprocessor
    if writer == "port":  # the port saves tensors from the card the same way: copied to the host
        fn = {"latent": lambda i: {**items[i], "latents": torch.from_numpy(items[i]["latents"])}}
    else:
        fn = {"latent": lambda i: items[i]}
    pre = make(rank=0, num_items=3, processor_fn=fn, save_dir=str(tmp_path), enable_precomputation=True)
    list(zip(range(3), pre.consume_once("latent", samples)))
    reader = (jax_data.PrecomputedDistributedDataPreprocessor if writer == "port"
              else data.PrecomputedDistributedDataPreprocessor)
    it = iter(reader.load_existing(0, 3, str(tmp_path), "latent"))
    for want in items + items[:1]:  # the set cycles
        got = next(it)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)


def test_in_memory_rounds_require_data_after_their_last_item():
    pre = precomputation.initialize_preprocessor(0, 2, {"x": lambda i: {"v": i}})
    assert pre.requires_data
    it = iter(pre.consume("x", iter([{"i": i} for i in range(4)])))
    assert next(it) == {"v": 0} and not pre.requires_data
    assert next(it) == {"v": 1} and pre.requires_data
    once = iter(pre.consume_once("x", iter([{"i": 5}, {"i": 6}])))
    assert [next(once)["v"] for _ in range(5)] == [5, 6, 5, 6, 5] and not pre.requires_data


def test_prefetcher_order_snapshots_and_errors():
    produced = []

    def source():
        for i in range(4):
            produced.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    pf = data.DevicePrefetcher(source(), torch.device("cpu"), depth=2, snapshot_fn=lambda: len(produced))
    for i in range(4):
        batch = next(pf)
        assert isinstance(batch["x"], torch.Tensor) and batch["x"][0].item() == i and pf.consumed_state == i + 1
    with pytest.raises(StopIteration):
        next(pf)
    pf.stop()

    def failing():
        yield {"x": np.zeros(1, np.float32)}
        raise RuntimeError("decode failed")

    pf = data.DevicePrefetcher(failing(), torch.device("cpu"))
    next(pf)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(pf)


def test_missing_optional_packages_raise_clearly(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        data.initialize_dataset("someone/some-dataset", "video")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    (tmp_path / "x.parquet").write_bytes(b"")
    with pytest.raises(ImportError, match="pyarrow"):
        data.initialize_dataset(str(tmp_path / "x.parquet"), "video")
