"""Host-side media IO through cv2 and PIL (port of `finetrainers_tpu/data/utils.py`).

Layouts: image (C, H, W), video (T, C, H, W), float32 in [-1, 1]; or the
decoded uint8 (H, W, 3) / (T, H, W, 3) frames with `to_float=False`. The
uint8 -> float conversion is numpy's, in float32 as x * (1/127.5) - 1: the
arithmetic of the JAX package's native kernel (`native/media_ops.cpp`), whose
result may differ from this one by an ulp where its compiler contracts the two
operations into one.
"""

from __future__ import annotations

import os
from typing import List, Optional

import cv2
import numpy as np
from PIL import Image

_SCALE = np.float32(1.0 / 127.5)


def _u8_hwc_to_float_chw(arr: np.ndarray) -> np.ndarray:
    """uint8 (..., H, W, C) -> contiguous float32 (..., C, H, W) in [-1, 1]."""
    out = np.ascontiguousarray(np.moveaxis(arr, -1, -3), dtype=np.float32)
    out *= _SCALE
    out -= np.float32(1.0)
    return out


def load_image(path_or_pil, to_float: bool = True) -> np.ndarray:
    """-> (C, H, W) float32 in [-1, 1], or the uint8 (H, W, 3) RGB frame."""
    if isinstance(path_or_pil, Image.Image):
        img = np.asarray(path_or_pil.convert("RGB"))
    else:
        img = cv2.imread(str(path_or_pil), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"Could not read image: {path_or_pil}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return _u8_hwc_to_float_chw(img) if to_float else img


def load_video(path, max_frames: Optional[int] = None, to_float: bool = True) -> np.ndarray:
    """-> (T, C, H, W) float32 in [-1, 1], or the uint8 (T, H, W, 3) RGB frames."""
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"Could not open video: {path}")
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"Video has no frames: {path}")
    video = np.stack(frames)
    return _u8_hwc_to_float_chw(video) if to_float else video


def save_video(frames: np.ndarray, path: str, fps: int = 8) -> None:
    """frames: (T, H, W, 3) uint8, written as mp4v."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _, h, w, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def save_image(image: np.ndarray, path: str) -> None:
    """image: (H, W, 3) uint8."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
