"""LoRA parameter selection (port of the training part of `finetrainers_tpu/lora.py`).

LoRA factors are ordinary parameters named `lora_A.weight` / `lora_B.weight`
inside `LoRADense` (peft's names), so training only them is a mask over the
module's named parameters; the frozen rest gets `requires_grad_(False)`.
Export and import of adapters are not ported yet (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch.nn as nn

LORA_KEYS = ("lora_A", "lora_B")


def trainable_mask(module: nn.Module, predicate: Callable[[str], bool]) -> Dict[str, bool]:
    """{parameter name: whether to train it}."""
    return {name: predicate(name) for name, _ in module.named_parameters()}


def lora_mask(module: nn.Module) -> Dict[str, bool]:
    """Mask selecting the LoRA factors only."""
    return trainable_mask(module, lambda name: any(f".{key}." in f".{name}" for key in LORA_KEYS))


def split_params(module: nn.Module, mask: Dict[str, bool]) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by name. Sets `requires_grad` from the
    mask, so autograd records no gradient for a frozen parameter."""
    trainable, frozen = {}, {}
    for name, param in module.named_parameters():
        param.requires_grad_(mask[name])
        (trainable if mask[name] else frozen)[name] = param
    return trainable, frozen
