"""Text-encoder condition processors (the parts of
`finetrainers_tpu/processors/text_encoders.py` the ported families run).

Encoders are duck-typed handles exposing `encode(captions, max_sequence_length)
-> (embeds, mask)` as numpy arrays, and for a CLIP slot `encode_pooled(captions)
-> (B, pooled_dim)`: the towers loaded from a local checkpoint
(`models/text_encoders/handles.py`: Llama, whose `supports_template_crop`
lets `LlamaProcessor` cut the prompt template's states; GLM; CLIP text, whose
pooled output `CLIPPooledProcessor` takes), or `HashEncoder`, the offline
stand-in the JAX package falls back to without one. The T5 towers are not
ported (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple, Union

import numpy as np

from .base import ProcessorMixin


class HashEncoder:
    """Deterministic offline stand-in for a text encoder. `encode` and
    `encode_pooled` are copied from `finetrainers_tpu/processors/text_encoders.py:25-55`;
    their outputs are the same bytes as the JAX package's."""

    def __init__(self, hidden_size: int = 32, max_length: int = 16, pooled_dim: Optional[int] = None):
        self.hidden_size = hidden_size
        self.max_length = max_length
        self.pooled_dim = pooled_dim

    def encode(self, captions: List[str], max_sequence_length: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        max_len = max_sequence_length or self.max_length
        embeds, masks = [], []
        for caption in captions:
            seed = int.from_bytes(hashlib.sha256(caption.encode()).digest()[:4], "little")
            rng = np.random.RandomState(seed)
            n_tokens = min(max(len(caption.split()), 1), max_len)
            e = np.zeros((max_len, self.hidden_size), np.float32)
            e[:n_tokens] = rng.randn(n_tokens, self.hidden_size) * 0.02
            m = np.zeros((max_len,), np.int32)
            m[:n_tokens] = 1
            embeds.append(e)
            masks.append(m)
        return np.stack(embeds), np.stack(masks)

    def encode_pooled(self, captions: List[str]) -> np.ndarray:
        dim = self.pooled_dim or self.hidden_size
        out = []
        for caption in captions:
            seed = int.from_bytes(hashlib.sha256(("pool" + caption).encode()).digest()[:4], "little")
            out.append(np.random.RandomState(seed).randn(dim).astype(np.float32) * 0.02)
        return np.stack(out)


class T5Processor(ProcessorMixin):
    """caption -> {embeds (masked), attention mask} (copied from
    `finetrainers_tpu/processors/text_encoders.py:111-127`)."""

    def __init__(self, output_names: List[str], use_attention_mask: bool = True,
                 input_names: Optional[dict] = None):
        if len(output_names) != 2:
            raise ValueError(f"T5Processor takes two output names, got {output_names}")
        self.output_names = output_names
        self.use_attention_mask = use_attention_mask
        self.input_names = input_names

    def forward(self, text_encoder, caption: Union[str, List[str]], max_sequence_length: int = 128, **kwargs):
        captions = [caption] if isinstance(caption, str) else list(caption)
        embeds, mask = text_encoder.encode(captions, max_sequence_length=max_sequence_length)
        if self.use_attention_mask:
            embeds = embeds * mask[..., None]
        return {self.output_names[0]: embeds, self.output_names[1]: mask.astype(np.int32)}


class CLIPPooledProcessor(ProcessorMixin):
    """caption -> {pooled projection embeds} (copied from
    `finetrainers_tpu/processors/text_encoders.py:119-131`)."""

    def __init__(self, output_names: List[str], input_names: Optional[dict] = None):
        if len(output_names) != 1:
            raise ValueError(f"CLIPPooledProcessor takes one output name, got {output_names}")
        self.output_names = output_names
        self.input_names = input_names

    def forward(self, text_encoder, caption: Union[str, List[str]], **kwargs):
        captions = [caption] if isinstance(caption, str) else list(caption)
        return {self.output_names[0]: text_encoder.encode_pooled(captions)}


# Copied from `finetrainers_tpu/processors/text_encoders.py:134-141`.
DEFAULT_HUNYUAN_PROMPT_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
)


class LlamaProcessor(ProcessorMixin):
    """HunyuanVideo's Llama prompt-template processor (copied from
    `finetrainers_tpu/processors/text_encoders.py:144-162`): the caption is
    wrapped in the system template and encoded at `max_sequence_length` plus
    the crop, and the template prefix's `crop_start` states are cut off. An
    encoder whose `supports_template_crop` is False (the offline stand-in)
    is cut by 0."""

    def __init__(self, output_names: List[str], prompt_template: Optional[str] = None, crop_start: int = 95):
        if len(output_names) != 2:
            raise ValueError(f"LlamaProcessor takes two output names, got {output_names}")
        self.output_names = output_names
        self.prompt_template = prompt_template or DEFAULT_HUNYUAN_PROMPT_TEMPLATE
        self.crop_start = crop_start

    def forward(self, text_encoder, caption: Union[str, List[str]], max_sequence_length: int = 256, **kwargs):
        captions = [caption] if isinstance(caption, str) else list(caption)
        templated = [self.prompt_template.format(c) for c in captions]
        crop = self.crop_start if getattr(text_encoder, "supports_template_crop", True) else 0
        embeds, mask = text_encoder.encode(templated, max_sequence_length=max_sequence_length + crop)
        return {self.output_names[0]: embeds[:, crop:], self.output_names[1]: mask[:, crop:].astype(np.int32)}


class CogView4GLMProcessor(ProcessorMixin):
    """caption -> {GLM hidden states} (copied from
    `finetrainers_tpu/processors/text_encoders.py:165-175`): the encoder's
    states at `max_sequence_length`, padded slots and all; no mask."""

    def __init__(self, output_names: List[str]):
        if len(output_names) != 1:
            raise ValueError(f"CogView4GLMProcessor takes one output name, got {output_names}")
        self.output_names = output_names

    def forward(self, text_encoder, caption: Union[str, List[str]], max_sequence_length: int = 1024, **kwargs):
        captions = [caption] if isinstance(caption, str) else list(caption)
        embeds, _ = text_encoder.encode(captions, max_sequence_length=max_sequence_length)
        return {self.output_names[0]: embeds}
