"""The port's text towers against the JAX package's: the Llama (GQA, a padding
mask), GLM (partial interleaved rotary, GQA, left padding) and CLIP text
(EOS pooling, a projection) handles of both packages load the same
checkpoint directory, written here, through the same stub tokenizer, and
the states each spec consumes (Llama `hidden_states[-3]`, GLM
`hidden_states[-2]`, CLIP's last state and pooled output) agree at 1e-5 in
fp32. The Llama checkpoint is split into two shards with an index, the GLM
one carries a `model.` prefix and an `lm_head`, the CLIP one a `text_model.`
prefix and its I64 `position_ids` buffer, as Hugging Face saves them."""

import json

import numpy as np
import pytest
import torch

from finetrainers_tpu.models.text_encoders import FlaxCLIPTextHandle, FlaxGlmHandle, FlaxLlamaHandle
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextHandle,
    CLIPTextTower,
    DecoderConfig,
    DecoderTextModel,
    GlmHandle,
    LlamaHandle,
)
from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict

torch.set_num_threads(1)
ATOL = RTOL = 1e-5

LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0)
GLM = dict(vocab_size=128, hidden_size=32, intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
           num_key_value_heads=2, head_dim=8, partial_rotary_factor=0.5, attention_bias=True, pad_token_id=0)
CLIP = dict(vocab_size=99, hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=77, eos_token_id=98, projection_dim=8)
CAPTIONS = ["a cat playing piano in the rain", "hello world"]


class StubTokenizer:
    """Word-count tokenizer (as the JAX package's tower tests stub it): ids
    3, 4, ... one per word plus one, then `eos_id` where given; 0 pads."""

    pad_token_id = 0

    def __init__(self, eos_id=None):
        self.eos_id = eos_id

    def __call__(self, texts, padding=None, max_length=None, truncation=None, return_tensors=None,
                 add_special_tokens=True, **kw):
        width = max_length if padding == "max_length" else min(max(len(t.split()) for t in texts) + 2, 16)
        ids = np.zeros((len(texts), width), np.int64)
        for i, t in enumerate(texts):
            n = min(len(t.split()) + 1, width - 1)
            ids[i, :n] = (np.arange(n) % 90) + 3
            if self.eos_id is not None:
                ids[i, n] = self.eos_id
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def _random_state(module, seed):
    """The port tower's random state, norm scales and biases drawn too (they start at 1 and 0)."""
    init_parameters_(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1:
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif "embed" in name or "embedding" in name:
                p.mul_(0.5)
    return module.state_dict()


def _write(path, config, state, shards=1):
    path.mkdir()
    (path / "config.json").write_text(json.dumps(config))
    if shards == 1:
        safetensors_save_dict(state, str(path / "model.safetensors"))
        return
    names = sorted(state)
    weight_map = {}
    for i in range(shards):
        part = {n: state[n] for n in names[i::shards]}
        file = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        safetensors_save_dict(part, str(path / file))
        weight_map.update({n: file for n in part})
    (path / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))


def _checkpoint(kind, path):
    if kind == "llama":
        state = _random_state(DecoderTextModel(DecoderConfig.llama(LLAMA), torch.float32), 0)
        _write(path, LLAMA, state, shards=2)
    elif kind == "glm":
        state = _random_state(DecoderTextModel(DecoderConfig.glm(GLM), torch.float32), 3)
        state = {f"model.{k}": v for k, v in state.items()}
        state["lm_head.weight"] = torch.randn(GLM["vocab_size"], GLM["hidden_size"])
        _write(path, GLM, state)
    else:
        state = _random_state(CLIPTextTower(CLIPTextConfig.from_hf(CLIP, with_projection=True), torch.float32), 6)
        state = {(k if k.startswith("text_projection") else f"text_model.{k}"): v for k, v in state.items()}
        state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
        _write(path, CLIP, state)


@pytest.mark.parametrize("kind", ["llama", "glm", "clip"])
def test_tower_handles_match_jax(kind, tmp_path):
    _checkpoint(kind, tmp_path / kind)
    path = str(tmp_path / kind)
    stub = StubTokenizer(eos_id=CLIP["eos_token_id"] if kind == "clip" else None)
    if kind == "llama":
        ours, theirs = LlamaHandle(path, dtype=torch.float32, device="cpu"), FlaxLlamaHandle(path)
    elif kind == "glm":
        ours, theirs = GlmHandle(path, dtype=torch.float32, device="cpu"), FlaxGlmHandle(path)
    else:
        ours = CLIPTextHandle(path, dtype=torch.float32, with_projection=True, device="cpu")
        theirs = FlaxCLIPTextHandle(path, with_projection=True)
    assert ours.tokenizer is None and theirs.tokenizer is None  # no tokenizer files: both warn and wait for one
    ours.tokenizer = theirs.tokenizer = stub
    length = {"llama": 16, "glm": 1024, "clip": 20}[kind]
    got, got_mask = ours.encode(CAPTIONS, max_sequence_length=length)
    want, want_mask = theirs.encode(CAPTIONS, max_sequence_length=length)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got_mask, want_mask)
    if kind == "llama":
        assert (got_mask == 0).any()  # the padding mask reaches the attention
    if kind == "glm":
        assert got.shape[1] % 16 == 0
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    if kind == "clip":
        pooled, want_pooled = ours.encode_pooled(CAPTIONS), np.asarray(theirs.encode_pooled(CAPTIONS))
        assert pooled.shape == (2, CLIP["projection_dim"])
        np.testing.assert_allclose(pooled, want_pooled, atol=ATOL, rtol=RTOL)


def test_finding_26_a_tower_under_flash_varlen_loses_causality(tmp_path):
    """ROADMAP.md section 3, finding 26 (JAX bug, reproduced): the runner
    (`--attn_provider`) and the trainer's validation (`--attn_provider_inference`)
    encode prompts inside the inference provider. Under `flash_varlen` (or
    `sage`) a decoder tower's causal-and-padding mask is read as a padding
    mask, so each slot also attends the slots after it: both packages' Llama
    towers give the same states there, and those differ from the causal ones."""
    from finetrainers_tpu.ops import attention_provider as jax_attention_provider
    from finetrainers_tpu_torch.ops import attention_provider

    _checkpoint("llama", tmp_path / "llama")
    path = str(tmp_path / "llama")
    ours, theirs = LlamaHandle(path, dtype=torch.float32, device="cpu"), FlaxLlamaHandle(path)
    ours.tokenizer = theirs.tokenizer = StubTokenizer()
    causal, _ = ours.encode(CAPTIONS, max_sequence_length=16)
    with attention_provider("flash_varlen"):
        got, _ = ours.encode(CAPTIONS, max_sequence_length=16)
    with jax_attention_provider("flash_varlen"):
        want, _ = theirs.encode(CAPTIONS, max_sequence_length=16)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    assert np.abs(got - causal).max() > 1e-2
