"""int8 frozen-weight storage (port of `finetrainers_tpu/utils/int8.py`).

`apply_int8_storage` stores the frozen 2D weight of each eligible linear
layer as int8 codes beside a `weight_qscale` buffer of fp32
per-output-channel scales (JAX's `kernel_qscale` sidecar); `LoRADense`
routes such a layer through `ops.int8_linear`, whose forward and
input-gradient products run on int8 GEMMs. The skip patterns are fp8's, so
embeddings, norms and the in/out projections stay in their dtype. The LoRA
factors and everything that trains stay as they are.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .fp8 import DEFAULT_SKIP_PATTERNS, _linear_layers, skipped

QSCALE_SUFFIX = "_qscale"


def apply_int8_storage(module: nn.Module, skip_patterns: Sequence[str] = tuple(DEFAULT_SKIP_PATTERNS)) -> nn.Module:
    """Quantize the frozen float 2D `weight` of each linear layer of `module`
    that no skip pattern names (`quantize_weight`: symmetric, one scale per
    output row) and register its scales as the buffer `weight_qscale`. In
    place; returns `module`."""
    from ..ops.int8_linear import quantize_weight

    for name, layer in _linear_layers(module):
        w = layer.weight
        if (w.requires_grad or w.ndim != 2 or not w.dtype.is_floating_point or w.dtype.itemsize < 2
                or skipped(f"{name}.weight", skip_patterns)):
            continue
        wq, sw = quantize_weight(w.detach())
        layer.weight = nn.Parameter(wq, requires_grad=False)
        layer.register_buffer("weight" + QSCALE_SUFFIX, sw)
    return module


def materialize_zeros_like(module: nn.Module) -> nn.Module:
    """Zero every int8 weight's codes and set its scales to 1e-8, in place (the
    JAX helper's full-size tree of zeros in the quantized dtypes, for tools that
    need the quantized layout's memory without the weights)."""
    with torch.no_grad():
        for _, layer in _linear_layers(module):
            if layer.weight.dtype == torch.int8:
                layer.weight.zero_()
                getattr(layer, "weight" + QSCALE_SUFFIX).fill_(1e-8)
    return module


def count_int8_bytes(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters() if p.dtype == torch.int8)
