"""Flux weights: the JAX package's flax names -> diffusers `FluxTransformer2DModel`
names, which are the port's module names, so the LoRA and full-rank exports
carry the keys `export_flux_transformer_state_dict` (JAX weights.py:53) writes."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from ..weight_utils import flax_key_to_torch, load_flax_state

# Copied from `finetrainers_tpu/models/flux/weights.py:13-38`; applied in order.
_RENAMES = [
    ("timestep_embedder_linear_1", "time_text_embed.timestep_embedder.linear_1"),
    ("timestep_embedder_linear_2", "time_text_embed.timestep_embedder.linear_2"),
    ("guidance_embedder_linear_1", "time_text_embed.guidance_embedder.linear_1"),
    ("guidance_embedder_linear_2", "time_text_embed.guidance_embedder.linear_2"),
    ("text_embedder_linear_1", "time_text_embed.text_embedder.linear_1"),
    ("text_embedder_linear_2", "time_text_embed.text_embedder.linear_2"),
    ("norm_out_linear", "norm_out.linear"),
    ("attn_add_q_proj", "attn.add_q_proj"),
    ("attn_add_k_proj", "attn.add_k_proj"),
    ("attn_add_v_proj", "attn.add_v_proj"),
    ("attn_norm_added_q", "attn.norm_added_q"),
    ("attn_norm_added_k", "attn.norm_added_k"),
    ("attn_to_add_out", "attn.to_add_out"),
    ("attn_to_out", "attn.to_out.0"),
    ("attn_to_q", "attn.to_q"),
    ("attn_to_k", "attn.to_k"),
    ("attn_to_v", "attn.to_v"),
    ("attn_norm_q", "attn.norm_q"),
    ("attn_norm_k", "attn.norm_k"),
    ("norm_linear", "norm.linear"),
    ("ff_context_net_0_proj", "ff_context.net.0.proj"),
    ("ff_context_net_2", "ff_context.net.2"),
    ("ff_net_0_proj", "ff.net.0.proj"),
    ("ff_net_2", "ff.net.2"),
]


def flux_key_map(flax_key: str) -> str:
    """Copied from `finetrainers_tpu/models/flux/weights.py:41-46`."""
    key = flax_key
    for ours, theirs in _RENAMES:
        key = key.replace(ours, theirs)
    return flax_key_to_torch(key)


def load_flax_params(model: nn.Module, flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Load the JAX package's Flux transformer parameters (flattened with "."
    separators; per-block or scan-stacked, with or without LoRA) strict into the port."""
    return load_flax_state(model, flat_params, key_map=flux_key_map)
