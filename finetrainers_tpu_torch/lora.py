"""LoRA parameter selection, export and import (port of `finetrainers_tpu/lora.py`,
one process, so without its multi-host gather).

LoRA factors are ordinary parameters named `lora_A.weight` / `lora_B.weight`
inside `LoRADense` (peft's names), so training only them is a mask over the
module's named parameters; the frozen rest gets `requires_grad_(False)`.
An adapter is `pytorch_lora_weights.safetensors`: peft names under the
`transformer.` prefix, torch layouts ((r, in) and (out, r)), and the LoRA
config as JSON under the `lora_config` metadata key, as the JAX trainer
writes it (`trainer/sft_trainer/trainer.py:403-412`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Tuple

import torch
import torch.nn as nn

from .utils.serialization import safetensors_load_dict, safetensors_load_metadata, safetensors_save_dict

LORA_KEYS = ("lora_A", "lora_B")
LORA_WEIGHTS_NAME = "pytorch_lora_weights.safetensors"
PREFIX = "transformer."


def _is_lora(name: str) -> bool:
    return any(f".{key}." in f".{name}" for key in LORA_KEYS)


def trainable_mask(module: nn.Module, predicate: Callable[[str], bool]) -> Dict[str, bool]:
    """{parameter name: whether to train it}."""
    return {name: predicate(name) for name, _ in module.named_parameters()}


def lora_mask(module: nn.Module) -> Dict[str, bool]:
    """Mask selecting the LoRA factors only."""
    return trainable_mask(module, _is_lora)


def split_params(module: nn.Module, mask: Dict[str, bool]) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by name. Sets `requires_grad` from the
    mask, so autograd records no gradient for a frozen parameter."""
    trainable, frozen = {}, {}
    for name, param in module.named_parameters():
        param.requires_grad_(mask[name])
        (trainable if mask[name] else frozen)[name] = param
    return trainable, frozen


def extract_lora_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{peft name: tensor} of the module's LoRA factors."""
    return {name: param.detach() for name, param in module.named_parameters() if _is_lora(name)}


def save_lora_weights(directory: str, lora_state: Mapping[str, torch.Tensor], lora_config: Dict[str, Any]) -> None:
    """Write `directory/pytorch_lora_weights.safetensors` from LoRA factors by
    peft name (`extract_lora_state_dict`). The port's modules already carry
    diffusers' names (the family's key map is applied where flax parameters
    are loaded, `models/*/weights.py`), so no key map is needed here."""
    os.makedirs(directory, exist_ok=True)
    safetensors_save_dict({PREFIX + name: value for name, value in lora_state.items()},
                          os.path.join(directory, LORA_WEIGHTS_NAME),
                          metadata={"lora_config": json.dumps(lora_config)})


def load_lora_weights(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state dict by the file's names, lora_config) from an adapter file or its directory."""
    if os.path.isdir(path):
        path = os.path.join(path, LORA_WEIGHTS_NAME)
    return safetensors_load_dict(path), json.loads(safetensors_load_metadata(path).get("lora_config", "{}"))


def apply_lora_state_dict(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy LoRA factors (peft names, with or without the `transformer.`
    prefix) into the module's parameters, cast to each one's dtype and device."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        for key, value in state_dict.items():
            name = key[len(PREFIX):] if key.startswith(PREFIX) else key
            if name not in params or not _is_lora(name):
                raise KeyError(f"LoRA key {key!r} not found in the module's LoRA factors")
            if tuple(params[name].shape) != tuple(value.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} does not match {tuple(params[name].shape)}")
            params[name].copy_(value)
    return module
