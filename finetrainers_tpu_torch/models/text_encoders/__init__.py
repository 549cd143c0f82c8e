from .handles import CLIPTextHandle, GlmHandle, LlamaHandle
from .towers import (
    CLIP_L_TEXT_CONFIG,
    GLM4_9B_CONFIG,
    LLAMA3_8B_CONFIG,
    CLIPTextConfig,
    CLIPTextTower,
    DecoderConfig,
    DecoderTextModel,
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
]
