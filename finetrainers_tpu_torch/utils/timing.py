"""Timers (port of `finetrainers_tpu/utils/timing.py`): the tracker's `timed`
spans (host clock, no device sync), and `ProfilerTrace`, a torch.profiler
capture of the card and the host written as a Chrome trace."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict

import torch

from ..constants import FINETRAINERS_ENABLE_TIMING


@contextlib.contextmanager
def timed(totals: Dict[str, float], key: str, lock: threading.Lock):
    """Add the span's host seconds to `totals[key]` under `lock` (nothing when
    FINETRAINERS_ENABLE_TIMING is "0")."""
    if not FINETRAINERS_ENABLE_TIMING:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        with lock:
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - start


class ProfilerTrace:
    """`with ProfilerTrace(log_dir): ...` writes `log_dir/trace.json`
    (CPU and, where a card is present, CUDA activity)."""

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self) -> "ProfilerTrace":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
