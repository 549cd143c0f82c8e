"""Wan 2.1 weights: flax names -> diffusers `WanTransformer3DModel` names."""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch.nn as nn

from ..weight_utils import flax_key_to_torch, load_flax_state


def wan_key_map(flax_key: str) -> str:
    """Copied from `finetrainers_tpu/models/wan/weights.py:13-27`."""
    key = flax_key
    key = key.replace("condition_embedder_time_embedder_linear_1", "condition_embedder.time_embedder.linear_1")
    key = key.replace("condition_embedder_time_embedder_linear_2", "condition_embedder.time_embedder.linear_2")
    key = key.replace("condition_embedder_time_proj", "condition_embedder.time_proj")
    key = key.replace("condition_embedder_text_embedder_linear_1", "condition_embedder.text_embedder.linear_1")
    key = key.replace("condition_embedder_text_embedder_linear_2", "condition_embedder.text_embedder.linear_2")
    key = key.replace("condition_embedder_image_embedder_norm1", "condition_embedder.image_embedder.norm1")
    key = key.replace("condition_embedder_image_embedder_norm2", "condition_embedder.image_embedder.norm2")
    key = key.replace("condition_embedder_image_embedder_ff_1", "condition_embedder.image_embedder.ff.net.0.proj")
    key = key.replace("condition_embedder_image_embedder_ff_2", "condition_embedder.image_embedder.ff.net.2")
    key = key.replace("ffn_net_0_proj", "ffn.net.0.proj")
    key = key.replace("ffn_net_2", "ffn.net.2")
    key = re.sub(r"\.to_out\.", ".to_out.0.", key)
    return flax_key_to_torch(key)


def load_flax_params(model: nn.Module, flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Load the JAX package's Wan transformer parameters (flattened with "."
    separators; per-block `blocks_<i>` or scan-stacked `blocks_scan`, with or
    without LoRA) strict into the port."""
    return load_flax_state(model, flat_params, key_map=wan_key_map)
