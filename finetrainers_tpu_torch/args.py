"""Training arguments (port of the fields of `finetrainers_tpu/args.py` and
`trainer/sft_trainer/config.py` that the train step, the checkpoints and the
LoRA export read, with their defaults). Parsing a command line (`train.py`)
is not ported yet (ROADMAP.md queue 1 item 7); a caller sets the fields
directly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class BaseArgs:
    training_type: Optional[str] = None
    # LoRA (SFTLowRankConfig)
    rank: int = 64
    lora_alpha: int = 64
    # Written into the exported adapter's metadata (the JAX trainer's LoRA mask trains every LoRA factor)
    target_modules: str = "(transformer_blocks|blocks).*(to_q|to_k|to_v|to_out)"
    # Attention providers in training, per module: "module:provider" or "provider" (transformer)
    attn_provider_training: List[str] = dataclasses.field(default_factory=list)
    # Diffusion
    flow_shift: float = 1.0
    flow_weighting_scheme: str = "none"
    flow_logit_mean: float = 0.0
    flow_logit_std: float = 1.0
    flow_mode_scale: float = 1.29
    # Training
    seed: Optional[int] = None
    train_steps: int = 1000
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    gradient_checkpointing_type: str = "full"
    logging_steps: int = 1
    # Checkpoints (`output_dir/checkpoints/finetrainers_step_<step>`) and exports (`output_dir/lora_weights/`)
    output_dir: str = "finetrainers-training"
    checkpointing_steps: int = 500
    checkpointing_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None  # "latest" or a step
    # Optimizer
    optimizer: str = "adamw"
    lr: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    lr_num_cycles: int = 1
    lr_power: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 1e-4
    epsilon: float = 1e-8
    max_grad_norm: float = 1.0
