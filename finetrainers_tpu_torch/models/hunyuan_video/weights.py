"""HunyuanVideo weights: the JAX package's flax names -> the names
`export_hunyuan_transformer_state_dict` (JAX weights.py:34) writes, which are
the port's module names, so the LoRA and full-rank exports carry JAX's keys.
JAX exports the refiner blocks as `context_embedder.token_refiner.refiner_blocks_<i>`
(its block-list rename knows no `refiner_blocks`), not diffusers'
`refiner_blocks.<i>`; the port keeps JAX's keys."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from ..flux.weights import _RENAMES as _FLUX_RENAMES
from ..weight_utils import flax_key_to_torch, load_flax_state

# Copied from `finetrainers_tpu/models/hunyuan_video/weights.py:13-20`; applied in order, then Flux's.
_RENAMES = [
    ("context_embedder_proj_in", "context_embedder.proj_in"),
    ("refiner_t_embedder_linear_1", "context_embedder.time_text_embed.timestep_embedder.linear_1"),
    ("refiner_t_embedder_linear_2", "context_embedder.time_text_embed.timestep_embedder.linear_2"),
    ("refiner_c_embedder_linear_1", "context_embedder.time_text_embed.text_embedder.linear_1"),
    ("refiner_c_embedder_linear_2", "context_embedder.time_text_embed.text_embedder.linear_2"),
    ("refiner_blocks", "context_embedder.token_refiner.refiner_blocks"),
] + list(_FLUX_RENAMES)


def hunyuan_key_map(flax_key: str) -> str:
    """Copied from `finetrainers_tpu/models/hunyuan_video/weights.py:23-27`."""
    key = flax_key
    for ours, theirs in _RENAMES:
        key = key.replace(ours, theirs)
    return flax_key_to_torch(key)


def load_flax_params(model: nn.Module, flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Load the JAX package's HunyuanVideo transformer parameters (flattened
    with "." separators; per-block or scan-stacked, with or without LoRA)
    strict into the port."""
    return load_flax_state(model, flat_params, key_map=hunyuan_key_map)
