"""LoRA parameter selection, export and import (port of `finetrainers_tpu/lora.py`,
one process, so without its multi-host gather).

LoRA factors are ordinary parameters named `lora_A.weight` / `lora_B.weight`
inside `LoRADense` (peft's names), so training only them is a mask over the
module's named parameters; the frozen rest gets `requires_grad_(False)`.
An adapter is `pytorch_lora_weights.safetensors`: peft names under the
`transformer.` prefix, torch layouts ((r, in) and (out, r)), and the LoRA
config as JSON under the `lora_config` metadata key, as the JAX trainer
writes it (`trainer/sft_trainer/trainer.py:403-412`). The inference runner
loads one back (`load_lora_weights`, `apply_lora_to_module_params`,
`scale_lora_b`), as JAX `examples/inference/inference.py:177-215` does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

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


def scale_lora_b(state_dict: Mapping[str, torch.Tensor], scale: float) -> Dict[str, torch.Tensor]:
    """peft's `lora_scale` folded into the B factors (peft or flax names; JAX
    runner :192-197)."""
    return {k: v * scale if ".lora_B." in k or k.endswith("lora_b") else v for k, v in state_dict.items()}


def apply_lora_to_module_params(module: nn.Module, state_dict: Mapping[str, Any],
                                key_map: Optional[Callable[[str], str]] = None) -> nn.Module:
    """Load an adapter into the module's LoRA factors (JAX `lora.py:140-155`):
    peft names (`transformer.blocks.0.attn1.to_q.lora_A.weight`) as they are,
    or the JAX package's flat flax names (`blocks_0.attn1.to_q.lora_a`, (in, r)
    layout) through the family's `key_map` and transposed. A key that names no
    LoRA factor of the module raises (JAX's peft path drops it unread)."""
    from .models.weight_utils import flax_to_torch_state_dict

    if not any(".lora_A." in k or ".lora_B." in k for k in state_dict):
        state_dict = {k: torch.from_numpy(v) for k, v in flax_to_torch_state_dict(
            {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v) for k, v in state_dict.items()},
            key_map).items()}
    return apply_lora_state_dict(module, state_dict)


def apply_auxiliary_weights(module: nn.Module, aux_path: str) -> nn.Module:
    """The non-LoRA weights a control adapter exports beside itself
    (`control_aux_weights.safetensors`; JAX `lora.py:115-128`): none is a
    no-op, as in JAX; a file raises, since the control trainer is not ported."""
    if os.path.exists(aux_path):
        raise NotImplementedError(f"{aux_path}: control adapters' auxiliary weights need the control trainer, "
                                  "which is not ported yet; see ROADMAP.md queue 1 item 9")
    return module
