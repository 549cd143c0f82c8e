"""Host-side image bucket and resize ops on numpy (C, H, W) float arrays
(copied from `finetrainers_tpu/functional/image.py`): cv2 resizes with the
same interpolation flags and rounding, and the same nearest-bucket choice."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import cv2
import numpy as np


def _resize_chw(image: np.ndarray, size: Tuple[int, int], interpolation: int) -> np.ndarray:
    """Resize a (C, H, W) array to (C, target_h, target_w)."""
    target_h, target_w = size
    hwc = np.ascontiguousarray(np.moveaxis(image, 0, -1))
    resized = cv2.resize(hwc, (target_w, target_h), interpolation=interpolation)
    if resized.ndim == 2:
        resized = resized[:, :, None]
    return np.moveaxis(resized, -1, 0)


def center_crop_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    _, height, width = image.shape
    crop_h, crop_w = size
    if height < crop_h or width < crop_w:
        raise ValueError(f"Image size {(height, width)} is smaller than the target size {size}.")
    top = (height - crop_h) // 2
    left = (width - crop_w) // 2
    return image[:, top : top + crop_h, left : left + crop_w]


def resize_crop_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    _, height, width = image.shape
    target_h, target_w = size
    scale = max(target_h / height, target_w / width)
    new_h, new_w = int(height * scale), int(width * scale)
    image = _resize_chw(image, (new_h, new_w), cv2.INTER_LINEAR)
    return center_crop_image(image, size)


def bicubic_resize_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    return _resize_chw(image, size, cv2.INTER_CUBIC)


def find_nearest_resolution_image(image: np.ndarray, resolution_buckets: List[Tuple[int, int]]) -> Tuple[int, int]:
    """The bucket whose aspect ratio best matches; the larger area on ties."""
    _, height, width = image.shape
    aspect_ratio = width / height

    def key(bucket: Sequence[int]):
        return abs((bucket[1] / bucket[0]) - aspect_ratio), (-bucket[0], -bucket[1])

    return tuple(min(resolution_buckets, key=key))


def resize_to_nearest_bucket_image(image: np.ndarray, resolution_buckets: List[Tuple[int, int]],
                                   resize_mode: str = "bicubic") -> np.ndarray:
    target_size = find_nearest_resolution_image(image, resolution_buckets)
    if resize_mode == "center_crop":
        return center_crop_image(image, target_size)
    if resize_mode == "resize_crop":
        return resize_crop_image(image, target_size)
    if resize_mode == "bicubic":
        return bicubic_resize_image(image, target_size)
    raise ValueError(f"Invalid resize_mode: {resize_mode}. Choose from 'center_crop', 'resize_crop', or 'bicubic'.")
