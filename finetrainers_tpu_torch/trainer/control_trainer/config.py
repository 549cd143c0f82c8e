"""The control trainer's arguments (port of
`finetrainers_tpu/trainer/control_trainer/config.py`): the control and
frame-conditioning types, and the flags `build_parser` adds for
`--training_type control-lora` (with the LoRA rank, alpha and target
modules, whose defaults are 64, 64 and JAX's regex) and
`control-full-finetune`. The parser's defaults are JAX's: `--control_type
canny`, `--frame_conditioning_type index`, index 0."""

from __future__ import annotations

import argparse
from enum import Enum


class ControlType(str, Enum):
    CANNY = "canny"
    CUSTOM = "custom"
    NONE = "none"


class FrameConditioningType(str, Enum):
    INDEX = "index"
    PREFIX = "prefix"
    RANDOM = "random"
    FIRST_AND_LAST = "first_and_last"
    FULL = "full"


CONTROL_TARGET_MODULES = "(transformer_blocks|blocks).*(to_q|to_k|to_v|to_out)"


class _ControlArgsBase:
    def _add_common(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--control_type", type=str, default=ControlType.CANNY.value,
                            choices=[c.value for c in ControlType])
        parser.add_argument("--train_qk_norm", action="store_true")
        parser.add_argument("--frame_conditioning_type", type=str, default=FrameConditioningType.INDEX.value,
                            choices=[f.value for f in FrameConditioningType])
        parser.add_argument("--frame_conditioning_index", type=int, default=0)
        parser.add_argument("--frame_conditioning_concatenate_mask", action="store_true")


class ControlLowRankConfig(_ControlArgsBase):
    """Control LoRA: the LoRA factors and, at full rank, the injection layer train."""

    def add_args(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("--rank", type=int, default=64)
        parser.add_argument("--lora_alpha", type=int, default=64)
        parser.add_argument("--target_modules", type=str, nargs="+", default=[CONTROL_TARGET_MODULES])
        self._add_common(parser)


class ControlFullRankConfig(_ControlArgsBase):
    def add_args(self, parser: argparse.ArgumentParser) -> None:
        self._add_common(parser)
