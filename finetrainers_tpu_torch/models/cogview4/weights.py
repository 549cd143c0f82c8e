"""CogView4 weights: the JAX package's flax names -> the names
`export_cogview4_transformer_state_dict` (JAX weights.py:45) writes, which
are the port's module names, so the LoRA, full-rank and control exports
carry JAX's keys."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from ..weight_utils import flax_key_to_torch, load_flax_state

# Copied from `finetrainers_tpu/models/cogview4/weights.py:12-28`; applied in order.
_RENAMES = [
    ("patch_embed_text_proj", "patch_embed.text_proj"),
    ("patch_embed_proj", "patch_embed.proj"),
    ("time_condition_embed_linear_1", "time_condition_embed.timestep_embedder.linear_1"),
    ("time_condition_embed_linear_2", "time_condition_embed.timestep_embedder.linear_2"),
    ("adaln_linear", "adaln.linear"),
    ("attn1_to_q", "attn1.to_q"),
    ("attn1_to_k", "attn1.to_k"),
    ("attn1_to_v", "attn1.to_v"),
    ("attn1_norm_q", "attn1.norm_q"),
    ("attn1_norm_k", "attn1.norm_k"),
    ("attn1_to_out", "attn1.to_out.0"),
    ("ff_net_0_proj", "ff.net.0.proj"),
    ("ff_net_2", "ff.net.2"),
    ("norm_out_linear", "norm_out.linear"),
    ("norm_out_ln", "norm_out.norm"),
]


def cogview4_key_map(flax_key: str) -> str:
    """Copied from `finetrainers_tpu/models/cogview4/weights.py:31-35`."""
    key = flax_key
    for ours, theirs in _RENAMES:
        key = key.replace(ours, theirs)
    return flax_key_to_torch(key)


def load_flax_params(model: nn.Module, flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Load the JAX package's CogView4 transformer parameters (flattened with
    "." separators; per-block or scan-stacked, with or without LoRA) strict
    into the port."""
    return load_flax_state(model, flat_params, key_map=cogview4_key_map)
