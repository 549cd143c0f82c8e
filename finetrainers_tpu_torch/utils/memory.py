"""Device memory statistics (port of `finetrainers_tpu/utils/memory.py`), from torch.cuda."""

from __future__ import annotations

from typing import Any, Dict

import torch


def bytes_to_gigabytes(x: int, precision: int = 3) -> float:
    return round(x / 1024**3, precision)


def get_memory_statistics(device: torch.device = None, precision: int = 3) -> Dict[str, Any]:
    """Allocated, reserved, peak allocated and total memory of the card, in
    GiB; empty where `device` is not a CUDA device."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    return {
        "memory_allocated": bytes_to_gigabytes(torch.cuda.memory_allocated(device), precision),
        "memory_reserved": bytes_to_gigabytes(torch.cuda.memory_reserved(device), precision),
        "max_memory_allocated": bytes_to_gigabytes(torch.cuda.max_memory_allocated(device), precision),
        "memory_limit": bytes_to_gigabytes(torch.cuda.get_device_properties(device).total_memory, precision),
    }
