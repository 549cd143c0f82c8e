from .handles import CLIPTextHandle, GlmHandle, LlamaHandle, T5Handle
from .towers import (
    CLIP_L_TEXT_CONFIG,
    GLM4_9B_CONFIG,
    LLAMA3_8B_CONFIG,
    T5_V1_1_XXL_CONFIG,
    UMT5_XXL_CONFIG,
    CLIPTextConfig,
    CLIPTextTower,
    DecoderConfig,
    DecoderTextModel,
    T5Config,
    T5EncoderTower,
)


__all__ = [
    "CLIP_L_TEXT_CONFIG",
    "GLM4_9B_CONFIG",
    "LLAMA3_8B_CONFIG",
    "CLIPTextConfig",
    "CLIPTextHandle",
    "CLIPTextTower",
    "DecoderConfig",
    "DecoderTextModel",
    "GlmHandle",
    "LlamaHandle",
    "T5Config",
    "T5EncoderTower",
    "T5Handle",
    "T5_V1_1_XXL_CONFIG",
    "UMT5_XXL_CONFIG",
]
