"""Dummy weights: the JAX package's flax names map to the port's module names
with the generic rule alone (`blocks_<i>.` -> `blocks.<i>.`, `kernel` ->
`weight`), so the exports carry JAX's keys."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from ..weight_utils import flax_key_to_torch, load_flax_state


def dummy_key_map(flax_key: str) -> str:
    return flax_key_to_torch(flax_key)


def load_flax_params(model: nn.Module, flat_params: Dict[str, np.ndarray]) -> nn.Module:
    """Load the JAX package's dummy transformer or VAE parameters (flattened
    with "." separators, with or without LoRA) strict into the port."""
    return load_flax_state(model, flat_params, key_map=dummy_key_map)
