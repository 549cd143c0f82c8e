"""LTX-Video weights: flax names -> diffusers `LTXVideoTransformer3DModel` names."""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch.nn as nn

from ..weight_utils import flax_key_to_torch, load_flax_state


def ltx_key_map(flax_key: str) -> str:
    """Copied from `finetrainers_tpu/models/ltx_video/weights.py:18-27`."""
    key = flax_key
    key = key.replace("time_embed.timestep_embedder_linear_1", "time_embed.emb.timestep_embedder.linear_1")
    key = key.replace("time_embed.timestep_embedder_linear_2", "time_embed.emb.timestep_embedder.linear_2")
    key = key.replace("caption_projection_linear_1", "caption_projection.linear_1")
    key = key.replace("caption_projection_linear_2", "caption_projection.linear_2")
    key = key.replace("ff_net_0_proj", "ff.net.0.proj")
    key = key.replace("ff_net_2", "ff.net.2")
    key = re.sub(r"\.to_out\.", ".to_out.0.", key)
    return flax_key_to_torch(key)


def load_flax_params(model: nn.Module, flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Load the JAX package's LTX transformer parameters (flattened with "."
    separators; plain or scan-stacked, with or without LoRA) strict into the port."""
    return load_flax_state(model, flat_params, key_map=ltx_key_map)
