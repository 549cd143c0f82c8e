"""Model/training-type registry (port of `finetrainers_tpu/config.py`).

LTX-Video, Wan 2.1, CogVideoX, Flux, HunyuanVideo, CogView4 and the dummy
family resolve for `lora` and `full-finetune`, and Wan and CogView4 also for
`control-lora` and `control-full-finetune` (their control specifications)."""

from __future__ import annotations

import importlib
from enum import Enum
from typing import Dict, Tuple


class ModelType(str, Enum):
    COGVIDEOX = "cogvideox"
    COGVIEW4 = "cogview4"
    FLUX = "flux"
    HUNYUAN_VIDEO = "hunyuan_video"
    LTX_VIDEO = "ltx_video"
    WAN = "wan"
    DUMMY = "dummy"


class TrainingType(str, Enum):
    LORA = "lora"
    FULL_FINETUNE = "full-finetune"
    CONTROL_LORA = "control-lora"
    CONTROL_FULL_FINETUNE = "control-full-finetune"


_SFT = (TrainingType.LORA, TrainingType.FULL_FINETUNE)
_CONTROL = (TrainingType.CONTROL_LORA, TrainingType.CONTROL_FULL_FINETUNE)
_LTX = ("finetrainers_tpu_torch.models.ltx_video", "LTXVideoModelSpecification")
_WAN = ("finetrainers_tpu_torch.models.wan", "WanModelSpecification")
_FLUX = ("finetrainers_tpu_torch.models.flux", "FluxModelSpecification")
_HUNYUAN = ("finetrainers_tpu_torch.models.hunyuan_video", "HunyuanVideoModelSpecification")
_COGVIDEOX = ("finetrainers_tpu_torch.models.cogvideox", "CogVideoXModelSpecification")
_COGVIEW4 = ("finetrainers_tpu_torch.models.cogview4", "CogView4ModelSpecification")
_COGVIEW4_CONTROL = ("finetrainers_tpu_torch.models.cogview4", "CogView4ControlModelSpecification")
_WAN_CONTROL = ("finetrainers_tpu_torch.models.wan", "WanControlModelSpecification")
_DUMMY = ("finetrainers_tpu_torch.models.dummy", "DummyModelSpecification")

# model -> {training types}: (module path, class name). The training types per
# family are the JAX package's.
_REGISTRY: Dict[ModelType, Dict[TrainingType, Tuple[str, str]]] = {
    ModelType.COGVIDEOX: {t: _COGVIDEOX for t in _SFT},
    ModelType.COGVIEW4: {**{t: _COGVIEW4 for t in _SFT}, **{t: _COGVIEW4_CONTROL for t in _CONTROL}},
    ModelType.FLUX: {t: _FLUX for t in _SFT},
    ModelType.HUNYUAN_VIDEO: {t: _HUNYUAN for t in _SFT},
    ModelType.LTX_VIDEO: {t: _LTX for t in _SFT},
    ModelType.WAN: {**{t: _WAN for t in _SFT}, **{t: _WAN_CONTROL for t in _CONTROL}},
    ModelType.DUMMY: {t: _DUMMY for t in _SFT},
}


def get_model_specification_cls(model_name: str, training_type: str):
    model_type = ModelType(model_name)
    tt = TrainingType(training_type)
    if tt not in _REGISTRY[model_type]:
        raise ValueError(
            f"Training type {training_type!r} is not supported for model {model_name!r}. "
            f"Supported training types: {sorted(t.value for t in _REGISTRY[model_type])}"
        )
    module_path, cls_name = _REGISTRY[model_type][tt]
    return getattr(importlib.import_module(module_path), cls_name)
