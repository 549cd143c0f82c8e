"""Trainer base (port of `finetrainers_tpu/trainer/base.py`): train state,
seeded randomness and the attention-provider context. One card, so no mesh
or process group (the parallel modes are ROADMAP.md queue 1 item 14)."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ..args import BaseArgs
from ..ops.attention import attention_provider
from ..state import State


class Trainer:
    def __init__(self, args: BaseArgs, model_specification) -> None:
        self.args = args
        self.model_specification = model_specification
        self.state = State()
        self.attn_provider_training = self._parse_attention_providers(args.attn_provider_training)
        self._init_determinism()

    def _init_determinism(self) -> None:
        """The trainer's draws (sigmas, posterior samples, noise) come from one
        generator on the spec's device, seeded with `args.seed` (0 when unset)."""
        seed = self.args.seed if self.args.seed is not None else 0
        self.state.generator_seed = seed
        self.generator = torch.Generator(device=self.model_specification.device).manual_seed(seed)

    @staticmethod
    def _parse_attention_providers(mapping: Optional[List[str]]) -> Dict[str, str]:
        """["transformer:flash", "vae:native"] -> {"transformer": "flash", "vae": "native"}."""
        out: Dict[str, str] = {}
        for entry in mapping or []:
            module, provider = entry.rsplit(":", 1) if ":" in entry else ("transformer", entry)
            out[module] = provider
        return out

    @contextlib.contextmanager
    def attention_provider_ctx(self, module: str = "transformer"):
        """Activate the provider configured for training a module, if any."""
        provider = self.attn_provider_training.get(module)
        if provider is None:
            yield
        else:
            with attention_provider(provider):
                yield
