from ...lora import AUX_WEIGHTS_NAME, save_control_aux_weights
from .config import ControlFullRankConfig, ControlLowRankConfig, ControlType, FrameConditioningType
from .data import (
    IterableControlDataset,
    apply_frame_conditioning_on_latents,
    apply_frame_conditioning_on_latents_torch,
)
from .trainer import ControlTrainer
