"""Control-signal processors (port of `finetrainers_tpu/processors/control.py`):
Canny edge maps and the target passed through as its own control. Both take
float media in [-1, 1], an image (C, H, W) or a video (T, C, H, W), on the
host in numpy, as the JAX package's do; cv2 is imported where it is used."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .base import ProcessorMixin


def _canny_frame(frame_chw: np.ndarray, low: float = 100, high: float = 200) -> np.ndarray:
    """(C, H, W) float in [-1, 1] -> its Canny edges replicated to 3 channels,
    (3, H, W) float in [-1, 1] (copied from JAX :15-23)."""
    import cv2

    hwc = np.moveaxis(frame_chw, 0, -1)
    u8 = ((hwc + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    gray = cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, low, high)
    out = np.repeat(edges[..., None], 3, axis=-1).astype(np.float32) / 127.5 - 1.0
    return np.moveaxis(out, -1, 0)


class CannyProcessor(ProcessorMixin):
    """Canny edge maps (thresholds 100 and 200) of an image or of each frame of a video."""

    def __init__(self, output_names: List[str], low: float = 100, high: float = 200,
                 input_names: Optional[Dict[str, str]] = None):
        if len(output_names) != 1:
            raise ValueError(f"CannyProcessor takes one output name, got {output_names}")
        self.output_names = output_names
        self.input_names = input_names
        self.low = low
        self.high = high

    def forward(self, input: Optional[np.ndarray] = None, **kwargs) -> Dict[str, Any]:
        if input is None:
            raise ValueError("CannyProcessor requires an input array")
        if input.ndim == 3:
            out = _canny_frame(input, self.low, self.high)
        elif input.ndim == 4:
            out = np.stack([_canny_frame(f, self.low, self.high) for f in input])
        else:
            raise ValueError(f"Expected a 3D or 4D array, got {input.ndim}D")
        return {self.output_names[0]: out}


class CopyProcessor(ProcessorMixin):
    """The target media passed through, copied, as its own control signal."""

    def __init__(self, output_names: List[str], input_names: Optional[Dict[str, str]] = None):
        if len(output_names) != 1:
            raise ValueError(f"CopyProcessor takes one output name, got {output_names}")
        self.output_names = output_names
        self.input_names = input_names

    def forward(self, input: Optional[np.ndarray] = None, **kwargs) -> Dict[str, Any]:
        return {self.output_names[0]: np.copy(input)}
