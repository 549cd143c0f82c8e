"""The port's media decode and bucketing against the JAX package's.

Videos and images that the test writes with cv2 into `tmp_path` (seeded numpy
frames, mp4v as the JAX package's own tests write them), and seeded numpy
arrays, through `finetrainers_tpu.data.utils`/`functional` and their
counterparts in `finetrainers_tpu_torch`:

- the decoded uint8 frames are equal;
- the float frames agree within 2 units in the last place of 1.0 (the JAX
  package converts with its native kernel where that builds, else with
  numpy's `/ 127.5`; the port computes the native kernel's `x * (1/127.5) - 1`
  in numpy, which a compiler may contract into one rounding);
- the image and video resize, crop and nearest-bucket functions give equal
  arrays on the same float input;
- `IterableDatasetPreprocessingWrapper` gives equal captions and frames to
  JAX's for each `reshape_mode`, with the id token and the LLM prefix removal.
"""

import cv2
import numpy as np
import pytest

from finetrainers_tpu.data import IterableDatasetPreprocessingWrapper as JaxWrapper
from finetrainers_tpu.data import VideoCaptionFilePairDataset as JaxPairs
from finetrainers_tpu.data import utils as jax_utils
from finetrainers_tpu.functional import image as jax_image
from finetrainers_tpu.functional import video as jax_video
from finetrainers_tpu_torch.data import IterableDatasetPreprocessingWrapper, VideoCaptionFilePairDataset
from finetrainers_tpu_torch.data import utils
from finetrainers_tpu_torch.functional import image, text, video

FLOAT_TOL = 2 * float(np.spacing(np.float32(1.0)))
MODES = ["bicubic", "center_crop", "resize_crop"]


def _write_video(path, frames, size, seed):
    w, h = size
    rng = np.random.RandomState(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    for _ in range(frames):
        writer.write((rng.rand(h, w, 3) * 255).astype(np.uint8))
    writer.release()


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    _write_video(root / "a.mp4", 9, (48, 32), 0)
    _write_video(root / "b.mp4", 6, (40, 40), 1)
    (root / "a.txt").write_text("The video shows a red ball")
    (root / "b.txt").write_text("In this video a cube spins")
    img = (np.random.RandomState(2).rand(30, 44, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(root / "c.png"), img)
    return root


def test_decoded_frames_equal_and_floats_within_2_ulp(media):
    for name in ("a.mp4", "b.mp4"):
        ours, ref = utils.load_video(media / name, to_float=False), jax_utils.load_video(media / name, to_float=False)
        assert ours.dtype == np.uint8 and np.array_equal(ours, ref)
        ours, ref = utils.load_video(media / name), jax_utils.load_video(media / name)
        assert ours.shape == ref.shape and ours.dtype == np.float32 and ours.flags.c_contiguous
        assert np.abs(ours - ref).max() <= FLOAT_TOL
    ours, ref = utils.load_image(media / "c.png", to_float=False), jax_utils.load_image(media / "c.png", to_float=False)
    assert np.array_equal(ours, ref)
    ours, ref = utils.load_image(media / "c.png"), jax_utils.load_image(media / "c.png")
    assert ours.shape == ref.shape == (3, 30, 44) and np.abs(ours - ref).max() <= FLOAT_TOL
    with pytest.raises(FileNotFoundError):
        utils.load_video(media / "missing.mp4")


def test_saved_video_decodes_to_its_frames(media, tmp_path):
    frames = utils.load_video(media / "a.mp4", to_float=False)
    utils.save_video(frames, str(tmp_path / "out" / "v.mp4"))
    again = utils.load_video(tmp_path / "out" / "v.mp4", to_float=False)
    assert again.shape == frames.shape  # mp4v is lossy: the shape round-trips, not the bytes


@pytest.mark.parametrize("mode", MODES)
def test_image_and_video_resizes_equal_jax(mode):
    rng = np.random.RandomState(3)
    img = rng.uniform(-1, 1, (3, 37, 53)).astype(np.float32)
    vid = rng.uniform(-1, 1, (11, 3, 37, 53)).astype(np.float32)
    buckets2 = [(16, 16), (24, 32), (32, 48)]
    buckets3 = [(4, 16, 16), (8, 24, 32), (8, 32, 40), (17, 32, 48)]
    assert image.find_nearest_resolution_image(img, buckets2) == jax_image.find_nearest_resolution_image(img, buckets2)
    assert video.find_nearest_video_bucket(vid, buckets3) == jax_video.find_nearest_video_bucket(vid, buckets3)
    assert np.array_equal(image.resize_to_nearest_bucket_image(img, buckets2, mode),
                          jax_image.resize_to_nearest_bucket_image(img, buckets2, mode))
    ours, first = video.resize_to_nearest_bucket_video(vid, buckets3, mode)
    ref, ref_first = jax_video.resize_to_nearest_bucket_video(vid, buckets3, mode)
    assert first == ref_first and ours.shape == ref.shape == (8, 3, 24, 32) and np.array_equal(ours, ref)
    with pytest.raises(ValueError):
        image.resize_to_nearest_bucket_image(img, buckets2, "stretch")


def test_caption_helpers_equal_jax():
    from finetrainers_tpu import constants as jax_constants
    from finetrainers_tpu.functional import text as jax_text
    from finetrainers_tpu_torch import constants

    assert constants.COMMON_LLM_START_PHRASES == jax_constants.COMMON_LLM_START_PHRASES
    for s in ("b'hello'", 'b"x y"', "plain", "b'", "bad'"):
        assert text.convert_byte_str_to_str(s) == jax_text.convert_byte_str_to_str(s)
    for s in ("The video shows a cat", "In this video, a dog", "A cat"):
        assert text.remove_prefix(s, constants.COMMON_LLM_START_PHRASES) == jax_text.remove_prefix(
            s, jax_constants.COMMON_LLM_START_PHRASES)


@pytest.mark.parametrize("mode", MODES)
def test_preprocessing_wrapper_equals_jax(media, mode):
    config = dict(id_token="TOK", video_resolution_buckets=[(4, 16, 16), (8, 24, 32)], reshape_mode=mode,
                  remove_common_llm_caption_prefixes=True)
    ours = list(IterableDatasetPreprocessingWrapper(VideoCaptionFilePairDataset(str(media)), "video", **config))
    ref = list(JaxWrapper(JaxPairs(str(media)), "video", **config))
    assert [o["caption"] for o in ours] == [r["caption"] for r in ref] == ["TOK shows a red ball", "TOK a cube spins"]
    assert [o["sample_id"] for o in ours] == [str(media / "a.mp4"), str(media / "b.mp4")]
    for o, r in zip(ours, ref):
        assert o["video"].shape == r["video"].shape
        assert np.abs(o["video"] - r["video"]).max() <= 8 * FLOAT_TOL  # the resize of values 1 ulp apart
    # On identical decoded input the bucketing is exact.
    frames = jax_utils.load_video(media / "a.mp4")
    assert np.array_equal(video.resize_to_nearest_bucket_video(frames, config["video_resolution_buckets"], mode)[0],
                          jax_video.resize_to_nearest_bucket_video(frames, config["video_resolution_buckets"], mode)[0])
