"""fp8 layerwise weight storage (port of `finetrainers_tpu/utils/fp8.py`).

Frozen linear weights are stored as float8_e4m3fn or float8_e5m2 and cast to
the compute dtype where they are used (`LoRADense`); norm scales, biases,
embeddings and the in/out projections stay in their dtype (the skip
patterns, searched in each dot-separated part of a parameter's name, as
the JAX package searches the parts of a flax path).

The cast is JAX's (ml_dtypes'): round to nearest even, and a value past the
format's range becomes what ml_dtypes gives it, a NaN of the value's sign
for float8_e4m3fn (beyond 464, the midpoint above its largest value 448;
torch saturates to 448 there) and +-inf for float8_e5m2 (from 61440; torch
agrees).
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

import torch
import torch.nn as nn

# Copied from `finetrainers_tpu/utils/fp8.py:21-29`.
DEFAULT_SKIP_PATTERNS = [
    "patch_embed", "pos_embed", "x_embedder", "context_embedder", "time_embed",
    r"^proj_in$", r"^proj_out$", "norm",
    "scale_shift_table",
]
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
_E4M3_OVERFLOW = 464.0  # |x| above it rounds past 448, the largest float8_e4m3fn value


def skipped(name: str, skip_patterns: Iterable[str]) -> bool:
    """Whether a skip pattern matches a part of the dot-separated `name`."""
    parts = name.split(".")
    return any(re.search(p, part) for p in skip_patterns for part in parts)


def to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast to an fp8 `dtype` as ml_dtypes casts it (see the module note)."""
    if dtype == torch.float8_e4m3fn:  # signed NaN, the byte ml_dtypes writes (0x7F or 0xFF)
        x = torch.where(x.float().abs() > _E4M3_OVERFLOW, torch.full_like(x, float("nan")).copysign(x), x)
    return x.to(dtype)


def _linear_layers(module: nn.Module):
    from ..models.layers import LoRADense

    return [(name, m) for name, m in module.named_modules() if isinstance(m, LoRADense)]


def apply_layerwise_storage_dtype(module: nn.Module, storage_dtype: torch.dtype = torch.float8_e4m3fn,
                                  skip_patterns: Sequence[str] = tuple(DEFAULT_SKIP_PATTERNS)) -> nn.Module:
    """Store the frozen 2D weight of each linear layer of `module` (its
    `weight`; a layer whose weight trains is left as it is) in
    `storage_dtype`, unless a skip pattern matches its name. In place;
    returns `module`."""
    if storage_dtype not in FP8_DTYPES:
        raise ValueError(f"fp8 storage takes {FP8_DTYPES}, got {storage_dtype}")
    for name, layer in _linear_layers(module):
        w = layer.weight
        if w.requires_grad or w.ndim != 2 or skipped(f"{name}.weight", skip_patterns):
            continue
        layer.weight = nn.Parameter(to_fp8(w.detach(), storage_dtype), requires_grad=False)
    return module


def count_fp8_bytes(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters() if p.dtype in FP8_DTYPES)
