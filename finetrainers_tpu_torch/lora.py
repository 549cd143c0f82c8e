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

import numpy as np
import torch
import torch.nn as nn

from .utils.serialization import safetensors_load_dict, safetensors_load_metadata, safetensors_save_dict

LORA_KEYS = ("lora_A", "lora_B")
LORA_WEIGHTS_NAME = "pytorch_lora_weights.safetensors"
AUX_WEIGHTS_NAME = "control_aux_weights.safetensors"
PREFIX = "transformer."
# The JAX package scans a block stack deeper than this (`layers.SCAN_DEPTH_THRESHOLD`).
SCAN_DEPTH_THRESHOLD = 8


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


def apply_auxiliary_weights(module: nn.Module, aux_path: str,
                            key_map: Optional[Callable[[str], str]] = None) -> nn.Module:
    """Load the non-LoRA weights a control adapter exports beside itself
    (`control_aux_weights.safetensors`: the full-rank injection layer and,
    under `--train_qk_norm`, the qk norms; JAX `lora.py:113-125`) into the
    module. The file has the JAX package's flat flax names and layouts
    (per-block or scan-stacked); they map through the family's `key_map`.
    No file is a no-op, as in JAX. A key that names no parameter raises
    KeyError, as in JAX; a shape that differs raises ValueError."""
    from .models.weight_utils import flax_to_torch_state_dict

    if not os.path.exists(aux_path):
        return module
    flat = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in safetensors_load_dict(aux_path).items()}
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, value in flax_to_torch_state_dict(flat, key_map).items():
            if name not in params:
                raise KeyError(f"Auxiliary weight {name!r} not found in the module's parameters")
            if tuple(params[name].shape) != tuple(value.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} does not match {tuple(params[name].shape)}")
            params[name].copy_(torch.as_tensor(np.ascontiguousarray(value)))
    return module


def save_control_aux_weights(directory: str, spec, trainable: Mapping[str, torch.Tensor]) -> None:
    """The trained non-LoRA weights of a LoRA run (a control model's injection
    layer and qk norms) to `directory/control_aux_weights.safetensors` (JAX
    `trainer/control_trainer/trainer.py:120-135`): the JAX package's flat flax
    names (stacked as `<list>_scan.block.*` where the JAX model scans its
    blocks) and layouts, fp32. Nothing is written where nothing but LoRA
    factors trains."""
    from .models.weight_utils import torch_to_flax_flat

    aux = {name: value.detach().float().cpu().numpy() for name, value in trainable.items() if not _is_lora(name)}
    if not aux:
        return
    flat = torch_to_flax_flat(aux, spec.transformer_key_map, renames=getattr(spec, "flax_renames", ()),
                              stack_blocks=spec.transformer_config["num_layers"] > SCAN_DEPTH_THRESHOLD)
    os.makedirs(directory, exist_ok=True)
    safetensors_save_dict({k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in flat.items()},
                          os.path.join(directory, AUX_WEIGHTS_NAME))
