"""The control trainer's data pieces against the JAX package's:

- `CannyProcessor` (cv2 Canny 100/200 on the [-1, 1] frame, replicated to 3
  channels) and `CopyProcessor` on images and videos: equal arrays;
- `apply_frame_conditioning_on_latents`, the numpy form, for every type,
  cut and padded, with the mask joined: equal arrays under the same
  `random.seed` (both draw from Python's `random`);
- the torch form of the traced `apply_frame_conditioning_on_latents_jax`
  for every type, with JAX's `prefix`/`random` draws handed over: equal;
- `IterableControlDataset`: the control type's signal added where the sample
  has no paired column, nothing for `none`, and the wrapped dataset's
  `state_dict` passed through, so a loader resumed from it yields what the
  unbroken one does;
- the folder datasets' `control_image`/`control_video` column (the port's
  addition: JAX's folder datasets drop it, ROADMAP.md section 3).
"""

import csv
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.data.dataset import ImageFolderDataset as JaxImageFolderDataset
from finetrainers_tpu.processors import CannyProcessor as JaxCanny
from finetrainers_tpu.processors import CopyProcessor as JaxCopy
from finetrainers_tpu.trainer.control_trainer.data import IterableControlDataset as JaxControlDataset
from finetrainers_tpu.trainer.control_trainer.data import apply_frame_conditioning_on_latents as jax_frame_np
from finetrainers_tpu.trainer.control_trainer.data import apply_frame_conditioning_on_latents_jax as jax_frame
from finetrainers_tpu_torch.data import DPDataLoader
from finetrainers_tpu_torch.data.dataset import ImageFolderDataset, VideoFolderDataset, initialize_dataset
from finetrainers_tpu_torch.data.dataset import wrap_iterable_dataset_for_preprocessing
from finetrainers_tpu_torch.processors import CannyProcessor, CopyProcessor
from finetrainers_tpu_torch.trainer.control_trainer import (
    ControlType,
    FrameConditioningType,
    IterableControlDataset,
    apply_frame_conditioning_on_latents,
    apply_frame_conditioning_on_latents_torch,
)

torch.set_num_threads(1)

TYPES = [t.value for t in FrameConditioningType]


def _media(shape, seed=0):
    """Smooth random media in [-1, 1] with edges (blocks upsampled)."""
    rng = np.random.RandomState(seed)
    *lead, c, h, w = shape
    coarse = rng.rand(*lead, c, h // 4, w // 4).astype(np.float32) * 2 - 1
    return np.repeat(np.repeat(coarse, 4, axis=-2), 4, axis=-1)


@pytest.mark.parametrize("shape", [(3, 32, 48), (5, 3, 24, 32)], ids=["image", "video"])
def test_canny_and_copy_match_jax(shape):
    x = _media(shape)
    got = CannyProcessor(["control"])(input=x)["control"]
    ref = JaxCanny(["control"])(input=x)["control"]
    assert got.dtype == ref.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got)) <= {-1.0, 1.0} and (got == 1.0).any()  # edges at 255, else 0
    copied = CopyProcessor(["control"])(input=x)["control"]
    np.testing.assert_array_equal(copied, JaxCopy(["control"])(input=x)["control"])
    assert copied is not x
    with pytest.raises(ValueError):
        CannyProcessor(["control"])(input=x[0, 0] if x.ndim == 3 else x[0, 0, 0])


@pytest.mark.parametrize("ftype", TYPES)
@pytest.mark.parametrize("expected,mask", [(5, False), (3, True), (7, True)], ids=["same", "cut_mask", "pad_mask"])
def test_numpy_frame_conditioning_matches_jax(ftype, expected, mask):
    latents = np.random.RandomState(1).randn(2, 4, 5, 3, 4).astype(np.float32)
    outs = []
    for fn in (apply_frame_conditioning_on_latents, jax_frame_np):
        random.seed(7)
        outs.append(fn(latents, expected, channel_dim=1, frame_dim=2, frame_conditioning_type=ftype,
                       frame_conditioning_index=2, concatenate_mask=mask))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (2, 8 if mask else 4, expected, 3, 4)


@pytest.mark.parametrize("ftype", TYPES)
@pytest.mark.parametrize("mask", [False, True], ids=["latents", "with_mask"])
def test_torch_frame_conditioning_matches_jax_traced_form(ftype, mask):
    latents = np.random.RandomState(2).randn(1, 4, 6, 3, 4).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    ref = np.asarray(jax_frame(jnp.asarray(latents), rng, frame_dim=2, channel_dim=1, frame_conditioning_type=ftype,
                               frame_conditioning_index=9, concatenate_mask=mask))
    draws = {"frame_keep": int(jax.random.randint(rng, (), 1, 7)),
             "frame_scores": np.asarray(jax.random.uniform(jax.random.fold_in(rng, 1), (6,)))}
    got = apply_frame_conditioning_on_latents_torch(torch.from_numpy(latents), frame_dim=2, channel_dim=1,
                                                    frame_conditioning_type=ftype, frame_conditioning_index=9,
                                                    concatenate_mask=mask, draws=draws)
    np.testing.assert_array_equal(got.numpy(), ref)
    kept = (got[:, :4] != 0).any(dim=(0, 1, 3, 4))
    if ftype == "index":  # the index past the end takes the last frame
        assert kept.tolist() == [False] * 5 + [True]
    elif ftype == "prefix":
        assert kept.tolist() == [i < draws["frame_keep"] for i in range(6)]
    elif ftype in ("random", "full"):
        assert int(kept.sum()) == (draws["frame_keep"] if ftype == "random" else 6)


def test_torch_frame_conditioning_draws_from_the_generator():
    latents = torch.randn(1, 2, 9, 2, 2)
    runs = [apply_frame_conditioning_on_latents_torch(latents, 2, 1, "random",
                                                      generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(*runs)
    kept = (runs[0] != 0).any(dim=(0, 1, 3, 4))
    assert 1 <= int(kept.sum()) <= 9


class _Source:
    """A stateful source of numbered samples (image and video)."""

    def __init__(self, n=6):
        self.n, self.pos = n, 0

    def __iter__(self):
        while self.pos < self.n:
            i = self.pos
            self.pos += 1
            yield {"caption": f"c{i}", "image": _media((3, 16, 16), seed=i), "video": _media((2, 3, 16, 16), seed=i),
                   "sample_id": i}

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, state):
        self.pos = state["pos"]


@pytest.mark.parametrize("control_type", [t.value for t in ControlType])
def test_control_dataset_matches_jax(control_type):
    got = list(IterableControlDataset(_Source(), control_type))
    ref = list(JaxControlDataset(_Source(), control_type))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in r:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(r[key]), err_msg=key)
    if control_type == "none":
        assert "control_image" not in got[0]
    else:
        assert got[0]["control_video"].shape == (2, 3, 16, 16)
    paired = {"image": _media((3, 16, 16)), "control_image": np.zeros((3, 16, 16), np.float32)}
    assert IterableControlDataset([paired], control_type)._process(paired)["control_image"] is paired["control_image"]


def test_control_dataset_resumes_the_loader_where_it_was():
    loader = DPDataLoader(rank=0, dataset=IterableControlDataset(_Source(), "canny"), collate_fn=lambda b: b[0])
    it = iter(loader)
    [next(it) for _ in range(2)]
    state = loader.state_dict()
    assert state["dp_rank_0"]["dataset"] == {"pos": 2}
    rest = [s["sample_id"] for s in it]
    resumed = DPDataLoader(rank=0, dataset=IterableControlDataset(_Source(), "canny"), collate_fn=lambda b: b[0])
    resumed.load_state_dict(state)
    assert [s["sample_id"] for s in resumed] == rest == [2, 3, 4, 5]
    assert not hasattr(IterableControlDataset([], "canny"), "state_dict")  # a source without state has none


@pytest.mark.parametrize("kind", ["image", "video"])
def test_folder_dataset_carries_the_control_column(kind, tmp_path):
    """`metadata.csv` with a `control_<kind>` column: the port's folder dataset
    gives its path, the wrapper decodes it resized to the sample's bucket;
    JAX's folder dataset drops the column."""
    rng = np.random.RandomState(0)
    for name in ("a", "b"):
        frame = (rng.rand(20, 28, 3) * 255).astype(np.uint8)
        if kind == "image":
            cv2.imwrite(str(tmp_path / f"{name}.png"), frame)
        else:
            writer = cv2.VideoWriter(str(tmp_path / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (28, 20))
            for _ in range(5):
                writer.write(frame)
            writer.release()
    ext = "png" if kind == "image" else "mp4"
    with open(tmp_path / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption", f"control_{kind}"])
        w.writeheader()
        w.writerow({"file_name": f"a.{ext}", "caption": "a lake", f"control_{kind}": f"b.{ext}"})
    ds = initialize_dataset(str(tmp_path), kind)
    assert isinstance(ds, ImageFolderDataset if kind == "image" else VideoFolderDataset)
    sample = next(iter(ds))
    assert sample[f"control_{kind}"] == str(tmp_path / f"b.{ext}")
    assert f"control_{kind}" not in next(iter(JaxImageFolderDataset(str(tmp_path))))
    buckets = {"image_resolution_buckets": [(16, 24)]} if kind == "image" else {"video_resolution_buckets": [(4, 16, 24)]}
    out = next(iter(wrap_iterable_dataset_for_preprocessing(initialize_dataset(str(tmp_path), kind), kind, buckets)))
    assert out[f"control_{kind}"].shape[-2:] == out[kind].shape[-2:] == (16, 24)
    if kind == "video":
        assert out["control_video"].shape[0] == out["video"].shape[0] == 4
