"""Host-side video bucket and resize ops on numpy (T, C, H, W) float arrays
(copied from `finetrainers_tpu/functional/video.py`): the frame-count bucket
(the largest count <= T, else the closest), the aspect-ratio match, linspace
frame subsampling and the three resize modes through cv2."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import cv2
import numpy as np

from .image import _resize_chw


def center_crop_video(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    _, _, height, width = video.shape
    crop_h, crop_w = size
    if height < crop_h or width < crop_w:
        raise ValueError(f"Video size {(height, width)} is smaller than the target size {size}.")
    top = (height - crop_h) // 2
    left = (width - crop_w) // 2
    return video[:, :, top : top + crop_h, left : left + crop_w]


def _resize_frames(video: np.ndarray, size: Tuple[int, int], interpolation: int) -> np.ndarray:
    return np.stack([_resize_chw(frame, size, interpolation) for frame in video])


def resize_crop_video(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    _, _, height, width = video.shape
    target_h, target_w = size
    scale = max(target_h / height, target_w / width)
    new_h, new_w = int(height * scale), int(width * scale)
    video = _resize_frames(video, (new_h, new_w), cv2.INTER_LINEAR)
    return center_crop_video(video, size)


def bicubic_resize_video(video: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    return _resize_frames(video, size, cv2.INTER_CUBIC)


def find_nearest_video_bucket(video: np.ndarray, resolution_buckets: List[Tuple[int, int, int]]) -> Tuple[int, int, int]:
    """The (frames, height, width) bucket: the largest frame count <= T (or the
    closest if none fits), then the best aspect-ratio match, the larger area on ties."""
    num_frames, _, height, width = video.shape
    aspect_ratio = width / height
    possible = [b for b in resolution_buckets if b[0] <= num_frames]
    if not possible:
        best_frames = min(resolution_buckets, key=lambda b: abs(b[0] - num_frames))[0]
    else:
        best_frames = max(possible, key=lambda b: b[0])[0]
    frame_filtered = [b for b in resolution_buckets if b[0] == best_frames]

    def key(bucket: Sequence[int]):
        return abs((bucket[2] / bucket[1]) - aspect_ratio), (-bucket[1], -bucket[2])

    return tuple(min(frame_filtered, key=key))


def resize_to_nearest_bucket_video(video: np.ndarray, resolution_buckets: List[Tuple[int, int, int]],
                                   resize_mode: str = "bicubic") -> Tuple[np.ndarray, bool]:
    """(T, C, H, W) -> (the video at its nearest bucket, first_frame_only). A
    longer video is subsampled to the bucket's frame count; a shorter one keeps
    its frames (`first_frame_only` stays False, as in the JAX package)."""
    target_frames, target_h, target_w = find_nearest_video_bucket(video, resolution_buckets)
    if video.shape[0] > target_frames:
        indices = np.linspace(0, video.shape[0] - 1, target_frames).astype(np.int64)
        video = video[indices]
    if resize_mode == "center_crop":
        return center_crop_video(video, (target_h, target_w)), False
    if resize_mode == "resize_crop":
        return resize_crop_video(video, (target_h, target_w)), False
    if resize_mode == "bicubic":
        return bicubic_resize_video(video, (target_h, target_w)), False
    raise ValueError(f"Invalid resize_mode: {resize_mode}. Choose from 'center_crop', 'resize_crop', or 'bicubic'.")
