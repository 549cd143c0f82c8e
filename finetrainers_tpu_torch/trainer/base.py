"""Trainer base (port of `finetrainers_tpu/trainer/base.py`): train state,
seeded randomness, the matmul precision knobs and the attention-provider
context. One card, so no mesh or process group (the parallel modes are
ROADMAP.md queue 1 item 10)."""

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
        args.check_ported()
        self.attn_provider_training = self._parse_attention_providers(args.attn_provider_training)
        self.attn_provider_inference = self._parse_attention_providers(args.attn_provider_inference)
        self._init_determinism()
        self._init_config_options()

    def _init_determinism(self) -> None:
        """The trainer's draws (sigmas, posterior samples, noise) come from one
        generator on the spec's device, seeded with `args.seed` (0 when unset)."""
        seed = self.args.seed if self.args.seed is not None else 0
        self.state.generator_seed = seed
        self.generator = torch.Generator(device=self.model_specification.device).manual_seed(seed)

    def _init_config_options(self) -> None:
        """`--allow_tf32` and `--float32_matmul_precision` (JAX trainer/base.py:91-100)."""
        if self.args.allow_tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        if self.args.float32_matmul_precision != "highest":
            torch.set_float32_matmul_precision(self.args.float32_matmul_precision)

    @staticmethod
    def _parse_attention_providers(mapping: Optional[List[str]]) -> Dict[str, str]:
        """["transformer:flash", "vae:native"] -> {"transformer": "flash", "vae": "native"}."""
        out: Dict[str, str] = {}
        for entry in mapping or []:
            module, provider = entry.rsplit(":", 1) if ":" in entry else ("transformer", entry)
            out[module] = provider
        return out

    @contextlib.contextmanager
    def attention_provider_ctx(self, module: str = "transformer", training: bool = True):
        """Activate the provider configured for a module in training (or, with
        `training=False`, in inference), if any."""
        provider = (self.attn_provider_training if training else self.attn_provider_inference).get(module)
        if provider is None:
            yield
        else:
            with attention_provider(provider):
                yield
