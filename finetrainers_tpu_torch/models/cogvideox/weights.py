"""CogVideoX weights: the JAX package's flax names -> the names
`export_cogvideox_transformer_state_dict` (JAX weights.py:45) writes, which
are the port's module names, so the LoRA and full-rank exports carry JAX's
keys."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from ..weight_utils import flax_key_to_torch, load_flax_state

# Copied from `finetrainers_tpu/models/cogvideox/weights.py:13-32`; applied in order.
_RENAMES = [
    ("patch_embed_text_proj", "patch_embed.text_proj"),
    ("patch_embed_proj", "patch_embed.proj"),
    ("pos_embedding", "patch_embed.pos_embedding"),
    ("time_embedding_linear_1", "time_embedding.linear_1"),
    ("time_embedding_linear_2", "time_embedding.linear_2"),
    ("ofs_embedding_linear_1", "ofs_embedding.linear_1"),
    ("ofs_embedding_linear_2", "ofs_embedding.linear_2"),
    ("norm1.norm_enc", "norm1.norm"),
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


def cogvideox_key_map(flax_key: str) -> str:
    """Copied from `finetrainers_tpu/models/cogvideox/weights.py:35-39`."""
    key = flax_key
    for ours, theirs in _RENAMES:
        key = key.replace(ours, theirs)
    return flax_key_to_torch(key)


def load_flax_params(model: nn.Module, flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Load the JAX package's CogVideoX transformer parameters (flattened with
    "." separators; per-block or scan-stacked, with or without LoRA) strict
    into the port."""
    return load_flax_state(model, flat_params, key_map=cogvideox_key_map)
