"""Loadable handles for the text towers (port of the text parts of
`finetrainers_tpu/models/text_encoders/handles.py`).

A handle is (tokenizer or None, tower, config) loaded from a Hugging Face
model directory (config.json and its safetensors, sharded or not), built on
the spec's device in the spec's `text_encoder_dtype`, and exposes the
duck-typed `encode` / `encode_pooled` the condition processors call
(`processors/text_encoders.py`), returning numpy arrays as JAX's handles do.
The tokenizer comes from `transformers` where it imports and the directory
(or `tokenizer_id`) holds one; otherwise it is None, with a warning, and
`encode` needs a caller to set `.tokenizer` first, as in JAX.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ...logging import get_logger
from ..weight_utils import load_named_weights
from .towers import CLIPTextConfig, CLIPTextTower, DecoderConfig, DecoderTextModel, T5Config, T5EncoderTower


logger = get_logger(__name__)


def _load_dir(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """(config dict, merged state dict) of a Hugging Face model directory: the
    shards its `model.safetensors.index.json` names, else every
    `*.safetensors` in it (`_load_dir`, handles.py:36-52)."""
    from ...utils.serialization import safetensors_load_dict, safetensors_load_index

    root = pathlib.Path(path)
    config = json.loads((root / "config.json").read_text())
    index = root / "model.safetensors.index.json"
    if index.exists():
        return config, safetensors_load_index(str(index))
    shards = sorted(root.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"No safetensors shards under {path}")
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(safetensors_load_dict(str(shard)))
    return config, state


def _strip_prefix(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """Drop `prefix` from the names that carry it, where any does (copied from handles.py:55-58)."""
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in state.items()}
    return state


# The files a local tokenizer directory holds (one at least): transformers'
# fast and slow tokenizers' serializations and configs.
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json", "vocab.txt",
                    "spiece.model", "merges.txt")


def _maybe_tokenizer(model_dir: str, tokenizer_id: Optional[str]):
    """transformers' `AutoTokenizer` for the directory (or `tokenizer_id`), or
    None with a warning where it cannot be had (handles.py:66-73). The import
    happens here, in the call: a machine may lack `transformers`, and importing
    it costs seconds, so a local directory with no tokenizer file is refused
    before it. Local files only: a Hub id is not fetched (JAX's handle would
    try the network)."""
    source = tokenizer_id or model_dir
    if os.path.isdir(source) and not any(os.path.exists(os.path.join(source, f)) for f in _TOKENIZER_FILES):
        logger.warning(f"No tokenizer available for {model_dir} (no tokenizer file in {source}); "
                       "encode() requires one")
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(source, local_files_only=True)
    except Exception as e:
        logger.warning(f"No tokenizer available for {model_dir} ({e}); encode() requires one")
        return None


def _build(module_fn, state: Dict[str, torch.Tensor], device: torch.device) -> nn.Module:
    """The tower built on `device` (uninitialised) and loaded by name from `state`."""
    with torch.device(device):
        module = module_fn()
    ignored = load_named_weights(module, state, ignore_unexpected=True)
    if ignored:
        logger.info(f"{type(module).__name__}: the checkpoint's {list(ignored)} have no place in the tower")
    return module.eval()


class _Handle:
    def __init__(self, device: Union[str, torch.device]) -> None:
        self.device = torch.device(device)

    @classmethod
    def from_tower(cls, config, module: nn.Module, tokenizer=None):
        """A handle around a tower already built (e.g. random weights at a
        published config), on the module's device, without reading a directory."""
        handle = cls.__new__(cls)
        _Handle.__init__(handle, next(module.parameters()).device)
        handle.config, handle.module, handle.tokenizer = config, module.eval(), tokenizer
        if cls is LlamaHandle:
            handle.num_layers_to_skip = 2
        return handle

    def _tokenize(self, captions: List[str], **kwargs) -> Dict[str, np.ndarray]:
        if self.tokenizer is None:
            raise RuntimeError(f"{type(self).__name__} has no tokenizer (none loaded; see the warning above). "
                               "Assign `.tokenizer` before encoding.")
        return self.tokenizer(captions, return_tensors="np", **kwargs)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)


class LlamaHandle(_Handle):
    """The Llama decoder (HunyuanVideo's text tower; `FlaxLlamaHandle`,
    handles.py:83-115): `encode(templated_captions, max_sequence_length)`
    returns `hidden_states[-(num_layers_to_skip + 1)]` and the padding mask
    (the processor crops the prompt template's prefix)."""

    supports_template_crop = True

    def __init__(self, model_dir: str, tokenizer_id: Optional[str] = None, dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        config, state = _load_dir(model_dir)
        self.config = DecoderConfig.llama(config)
        self.module = _build(lambda: DecoderTextModel(self.config, dtype), _strip_prefix(state, "model."),
                             self.device)
        self.tokenizer = _maybe_tokenizer(model_dir, tokenizer_id)
        self.num_layers_to_skip = 2

    @torch.no_grad()
    def encode(self, captions: List[str], max_sequence_length: int = 256) -> Tuple[np.ndarray, np.ndarray]:
        batch = self._tokenize(captions, padding="max_length", max_length=max_sequence_length, truncation=True)
        mask = self._ids(batch["attention_mask"])
        hidden = self.module(self._ids(batch["input_ids"]), attention_mask=mask)
        embeds = hidden[-(self.num_layers_to_skip + 1)]
        return embeds.float().cpu().numpy(), mask.cpu().numpy().astype(np.int32)


class GlmHandle(_Handle):
    """The GLM decoder (CogView4's text tower; `FlaxGlmHandle`, handles.py:118-147):
    `encode` pads to the longest caption, left-pads the ids to the next
    multiple of 16 (16 more where the length is one already, as JAX and the
    reference pad) and returns `hidden_states[-2]` with a mask of ones: the
    attention is causal only, no padding mask is passed."""

    def __init__(self, model_dir: str, tokenizer_id: Optional[str] = None, dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        config, state = _load_dir(model_dir)
        self.config = DecoderConfig.glm(config)
        self.module = _build(lambda: DecoderTextModel(self.config, dtype), _strip_prefix(state, "model."),
                             self.device)
        self.tokenizer = _maybe_tokenizer(model_dir, tokenizer_id)

    @torch.no_grad()
    def encode(self, captions: List[str], max_sequence_length: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
        batch = self._tokenize(captions, padding="longest", max_length=max_sequence_length, truncation=True,
                               add_special_tokens=True)
        ids = np.asarray(batch["input_ids"], np.int64)
        pad_length = 16 - ids.shape[1] % 16
        if pad_length > 0:
            pad_id = self.tokenizer.pad_token_id or 0
            ids = np.concatenate([np.full((ids.shape[0], pad_length), pad_id, np.int64), ids], axis=1)
        hidden = self.module(self._ids(ids))
        return hidden[-2].float().cpu().numpy(), np.ones(ids.shape, np.int32)


class CLIPTextHandle(_Handle):
    """CLIP's text tower (HunyuanVideo's pooled slot; `FlaxCLIPTextHandle`,
    handles.py:150-184): `encode` returns the last hidden state and the
    tokenizer's mask, `encode_pooled` the pooled (EOS-position) state at 77
    tokens. A checkpoint's `text_model.` prefix is dropped; `text_projection`
    sits outside it."""

    def __init__(self, model_dir: str, tokenizer_id: Optional[str] = None, dtype: torch.dtype = torch.bfloat16,
                 with_projection: bool = False, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        config, state = _load_dir(model_dir)
        self.config = CLIPTextConfig.from_hf(config, with_projection=with_projection)
        self.module = _build(lambda: CLIPTextTower(self.config, dtype), _strip_prefix(state, "text_model."),
                             self.device)
        self.tokenizer = _maybe_tokenizer(model_dir, tokenizer_id)

    @torch.no_grad()
    def encode(self, captions: List[str], max_sequence_length: int = 77) -> Tuple[np.ndarray, np.ndarray]:
        batch = self._tokenize(captions, padding="max_length", max_length=max_sequence_length, truncation=True)
        last, _ = self.module(self._ids(batch["input_ids"]))
        return last.float().cpu().numpy(), np.asarray(batch["attention_mask"], np.int32)

    @torch.no_grad()
    def encode_pooled(self, captions: List[str]) -> np.ndarray:
        batch = self._tokenize(captions, padding="max_length", max_length=77, truncation=True)
        _, pooled = self.module(self._ids(batch["input_ids"]))
        return pooled.float().cpu().numpy()


class T5Handle(_Handle):
    """The T5 or UMT5 encoder (Wan's UMT5, LTX-Video's and CogVideoX's T5;
    `FlaxT5Handle`, processors/text_encoders.py:57-100): `encode(captions,
    max_sequence_length)` pads every caption to `max_sequence_length`
    (truncating), and returns the last hidden state and the tokenizer's mask.
    `model_dir` is the tower's directory, or a pipeline root holding
    `text_encoder/` and no config.json of its own (`resolve`). Local files
    only: JAX's handle would try the Hub.

    JAX loads a UMT5 directory into transformers' Flax T5, which holds one
    relative-attention table (layer 0's) for every layer, so layers 1..N-1's
    own tables go unused; the port computes the same function and logs that
    once (ROADMAP.md section 3, finding 24)."""

    def __init__(self, model_dir: str, tokenizer_id: Optional[str] = None, dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        model_dir = self.resolve(model_dir)
        config, state = _load_dir(model_dir)
        self.config = T5Config.from_hf(config)
        self.module = _build(lambda: T5EncoderTower(self.config, dtype), state, self.device)
        unused = [k for k in state if k.endswith("relative_attention_bias.weight")
                  and not k.startswith("encoder.block.0.")]
        if unused:
            logger.warning(f"{model_dir}: {len(unused)} layers' relative-attention tables ({self.config.model_type}) "
                           "go unused: layer 0's serves every layer, as in JAX's Flax T5 (ROADMAP.md section 3, "
                           "finding 24)")
        self.tokenizer = _maybe_tokenizer(model_dir, tokenizer_id)

    @staticmethod
    def resolve(path: Optional[str]) -> Optional[str]:
        """A pipeline root with `text_encoder/` and no config.json of its own ->
        its `text_encoder/`; any other path as it is (JAX's resolution)."""
        if path and os.path.isdir(path):
            sub = os.path.join(path, "text_encoder")
            if os.path.isdir(sub) and not os.path.exists(os.path.join(path, "config.json")):
                return sub
        return path

    @torch.no_grad()
    def encode(self, captions: List[str], max_sequence_length: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        batch = self._tokenize(captions, padding="max_length", max_length=max_sequence_length, truncation=True)
        mask = self._ids(batch["attention_mask"])
        states = self.module(self._ids(batch["input_ids"]), attention_mask=mask)
        return states.float().cpu().numpy(), mask.cpu().numpy().astype(np.int32)
