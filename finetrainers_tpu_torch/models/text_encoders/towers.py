"""The text towers: the Llama and GLM decoders, the CLIP text encoder (port
of the text parts of `finetrainers_tpu/models/text_encoders/towers.py`) and
the T5/UMT5 encoder (the function JAX computes through transformers'
`FlaxT5EncoderModel`, `processors/text_encoders.py:57-100`).

Module and parameter names are Hugging Face's (`embed_tokens`,
`layers.{i}.self_attn.q_proj`, `layers.{i}.mlp.gate_up_proj`, `norm`;
`embeddings.token_embedding`, `encoder.layers.{i}.self_attn.out_proj`,
`final_layer_norm`, `text_projection`; `shared`,
`encoder.block.{i}.layer.0.SelfAttention.q`, `layer.1.DenseReluDense.wi_0`),
so a checkpoint loads by name (`weight_utils.load_named_weights`). What the
diffusion specs consume:
  - Llama: HunyuanVideo's prompt states, `hidden_states[-3]` (the handle's
    `num_layers_to_skip` 2), under a causal and padding mask;
  - GLM: CogView4's prompt states, `hidden_states[-2]`, causal only;
  - CLIP text: the pooled state at the first EOS position, projected where the
    config has a projection;
  - T5/UMT5: the last hidden state under a padding mask (Wan, LTX-Video and
    CogVideoX's prompt states), its attention plain fp32 math with an additive
    relative bias, which K1 does not take.
Each decoder and CLIP attention passes its dense boolean mask to
`attention_dispatch`: on the card `auto` runs it through K1's mask branch,
with GQA's kv heads repeated before it; on the CPU through fp32 math, as JAX
`auto` sends it to XLA.
The towers compute in the dtype they are built with (the spec's
`text_encoder_dtype`); JAX builds its towers in fp32 whatever that flag says
(ROADMAP.md section 3, finding 21). CLIP's vision tower is not ported: it needs
head dim 80 and JAX's main path never runs it (finding 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention_dispatch
from ..layers import LayerNorm, LoRADense, RMSNorm


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Llama and GLM (Hugging Face config.json names; copied from
    `finetrainers_tpu/models/text_encoders/towers.py:35-96`)."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    attention_bias: bool = False
    partial_rotary_factor: float = 1.0
    interleaved_rope: bool = False  # GLM rotates pairs (0, 1), (2, 3), ...; Llama rotates halves
    fused_gate_up: bool = False  # GLM's gate_up_proj; Llama's separate gate_proj and up_proj

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def llama(cls, cfg: dict) -> "DecoderConfig":
        return cls(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"), rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0), attention_bias=cfg.get("attention_bias", False),
        )

    @classmethod
    def glm(cls, cfg: dict) -> "DecoderConfig":
        return cls(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"), rms_norm_eps=cfg.get("rms_norm_eps", 1.5625e-07),
            rope_theta=cfg.get("rope_theta", 10000.0), attention_bias=cfg.get("attention_bias", True),
            partial_rotary_factor=cfg.get("partial_rotary_factor", 0.5), interleaved_rope=True, fused_gate_up=True,
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP's text encoder (copied from `towers.py:99-123`)."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # set for CLIPTextModelWithProjection

    @classmethod
    def from_hf(cls, cfg: dict, with_projection: bool = False) -> "CLIPTextConfig":
        return cls(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
            max_position_embeddings=cfg.get("max_position_embeddings", 77),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5), hidden_act=cfg.get("hidden_act", "quick_gelu"),
            eos_token_id=cfg.get("eos_token_id", 49407),
            projection_dim=cfg.get("projection_dim") if with_projection else None,
        )


# The published towers' config.json fields that the configs above read.
# GLM-4-9B, CogView4's text encoder: Hugging Face `THUDM/glm-4-9b-hf`, config.json.
GLM4_9B_CONFIG = dict(
    vocab_size=151552, hidden_size=4096, intermediate_size=13696, num_hidden_layers=40, num_attention_heads=32,
    num_key_value_heads=2, head_dim=128, rms_norm_eps=1.5625e-07, rope_theta=10000.0, attention_bias=True,
    partial_rotary_factor=0.5, pad_token_id=151329,
)
# HunyuanVideo's Llama-3-8B: Hugging Face `xtuner/llava-llama-3-8b-v1_1-transformers`, text_config.
LLAMA3_8B_CONFIG = dict(
    vocab_size=128320, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=500000.0, attention_bias=False,
)
# CLIP-L's text encoder (HunyuanVideo's text_encoder_2): Hugging Face `openai/clip-vit-large-patch14`,
# text_config. Its eos_token_id 2 is the published value (ROADMAP.md section 3, finding 23).
CLIP_L_TEXT_CONFIG = dict(
    vocab_size=49408, hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
    max_position_embeddings=77, layer_norm_eps=1e-5, hidden_act="quick_gelu", eos_token_id=2,
)


def decoder_rope(seq_len: int, head_dim: int, theta: float, partial: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (S, rot_dim / 2) fp32, for the rotated slice of each
    head, rot_dim = head_dim * partial (`_decoder_rope`, towers.py:145-150)."""
    rot_dim = int(head_dim * partial)
    inv_freq = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))
    angles = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_decoder_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleaved: bool) -> torch.Tensor:
    """x: (B, S, N, H). Rotates the first 2 * cos.shape[-1] dims of each head in
    fp32; the rest pass through (GLM's partial rotary). Llama rotates halves,
    GLM interleaved pairs (`_apply_decoder_rope`, towers.py:153-172)."""
    rot = 2 * cos.shape[-1]
    x32 = x.float()
    x_rot, x_pass = x32[..., :rot], x32[..., rot:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x_rot.shape)
    else:
        x1, x2 = x_rot.chunk(2, dim=-1)
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, x_pass], dim=-1).to(x.dtype)


class Embedding(nn.Module):
    """A lookup table stored in the compute dtype (flax `nn.Embed` with fp32
    parameters and a compute dtype gives the same values)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class _DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        h, n, n_kv = cfg.resolved_head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        self.q_proj = LoRADense(cfg.hidden_size, n * h, bias=cfg.attention_bias, dtype=dtype)
        self.k_proj = LoRADense(cfg.hidden_size, n_kv * h, bias=cfg.attention_bias, dtype=dtype)
        self.v_proj = LoRADense(cfg.hidden_size, n_kv * h, bias=cfg.attention_bias, dtype=dtype)
        self.o_proj = LoRADense(n * h, cfg.hidden_size, bias=False, dtype=dtype)

    def forward(self, x, mask, cos, sin):
        cfg = self.cfg
        h, n, n_kv = cfg.resolved_head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        b, s, _ = x.shape
        q = apply_decoder_rope(self.q_proj(x).reshape(b, s, n, h), cos, sin, cfg.interleaved_rope)
        k = apply_decoder_rope(self.k_proj(x).reshape(b, s, n_kv, h), cos, sin, cfg.interleaved_rope)
        v = self.v_proj(x).reshape(b, s, n_kv, h)
        out = attention_dispatch(q, k, v, attn_mask=mask, scale=h**-0.5)
        return self.o_proj(out.reshape(b, s, n * h))


class _DecoderMLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.fused = cfg.fused_gate_up
        if self.fused:
            self.gate_up_proj = LoRADense(cfg.hidden_size, 2 * cfg.intermediate_size, bias=False, dtype=dtype)
        else:
            self.gate_proj = LoRADense(cfg.hidden_size, cfg.intermediate_size, bias=False, dtype=dtype)
            self.up_proj = LoRADense(cfg.hidden_size, cfg.intermediate_size, bias=False, dtype=dtype)
        self.down_proj = LoRADense(cfg.intermediate_size, cfg.hidden_size, bias=False, dtype=dtype)

    def forward(self, x):
        if self.fused:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype)
        self.self_attn = _DecoderAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype)
        self.mlp = _DecoderMLP(cfg, dtype)

    def forward(self, x, mask, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), mask, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class DecoderTextModel(nn.Module):
    """The causal decoder trunk (LlamaModel / GlmModel; `DecoderTextModel`,
    towers.py:227-258). `forward` returns Hugging Face's `hidden_states` list:
    [embeddings, after layer 1, ..., after layer N-1, the final norm of layer
    N's output], which the specs index from the end."""

    def __init__(self, config: DecoderConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size, dtype)
        self.layers = nn.ModuleList([_DecoderLayer(config, dtype) for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, eps=config.rms_norm_eps, dtype=dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """input_ids (B, S) ints; attention_mask (B, S), 1 = a real token. The
        mask each attention takes is causal, and with `attention_mask` also
        off at the padded keys: (B or 1, 1, S, S) boolean."""
        cfg = self.config
        x = self.embed_tokens(input_ids)
        s = input_ids.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.to(device=x.device, dtype=torch.bool)[:, None, None, :]
        cos, sin = decoder_rope(s, cfg.resolved_head_dim, cfg.rope_theta, cfg.partial_rotary_factor, x.device)
        hidden_states = [x]
        for i, layer in enumerate(self.layers):
            x = layer(x, mask, cos, sin)
            if i < len(self.layers) - 1:
                hidden_states.append(x)
        hidden_states.append(self.norm(x))
        return hidden_states


def _clip_act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"Unknown CLIP activation {name!r}")


class _CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads = num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, LoRADense(hidden_size, hidden_size, dtype=dtype))

    def forward(self, x, mask):
        b, s, d = x.shape
        hd = d // self.num_heads
        q, k, v = (proj(x).reshape(b, s, self.num_heads, hd) for proj in (self.q_proj, self.k_proj, self.v_proj))
        out = attention_dispatch(q, k, v, attn_mask=mask, scale=hd**-0.5)
        return self.out_proj(out.reshape(b, s, d))


class _CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.fc1 = LoRADense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = LoRADense(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)
        self.act = _clip_act(cfg.hidden_act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        norm = lambda: LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, elementwise_affine=True,  # noqa: E731
                                 dtype=dtype)
        self.layer_norm1 = norm()
        self.self_attn = _CLIPAttention(cfg.hidden_size, cfg.num_attention_heads, dtype)
        self.layer_norm2 = norm()
        self.mlp = _CLIPMLP(cfg, dtype)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, mask):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size, dtype)
        self.position_embedding = Embedding(cfg.max_position_embeddings, cfg.hidden_size, dtype)

    def forward(self, input_ids):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(positions)[None]


class CLIPTextTower(nn.Module):
    """CLIPTextModel(WithProjection) (`CLIPTextTower`, towers.py:387-412):
    `forward(input_ids)` -> (last_hidden_state, pooled), pooled the final
    norm's state at the first `eos_token_id` position (position 0 where the
    ids hold none), projected by `text_projection` where the config has a
    projection dim. The attention is causal."""

    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config = config
        self.embeddings = _CLIPTextEmbeddings(config, dtype)
        self.encoder = _CLIPEncoder(config, dtype)
        self.final_layer_norm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps, elementwise_affine=True,
                                          dtype=dtype)
        if config.projection_dim:
            self.text_projection = LoRADense(config.hidden_size, config.projection_dim, bias=False, dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s = input_ids.shape
        x = self.embeddings(input_ids)
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
        x = self.final_layer_norm(self.encoder(x, mask))
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos_pos]
        if self.config.projection_dim:
            pooled = self.text_projection(pooled)
        return x, pooled


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5's and UMT5's encoder (Hugging Face config.json names). JAX encodes
    both through transformers' `FlaxT5EncoderModel` (`FlaxT5Handle`,
    `processors/text_encoders.py:57-100`), which builds the relative-attention
    table in layer 0 only, whatever `model_type` says (finding 24)."""

    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    num_layers: int
    num_heads: int
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"
    model_type: str = "t5"

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.split("-")[0] == "gated"

    @property
    def act(self) -> str:
        """transformers' `dense_act_fn`: "gated-gelu" runs "gelu_new" (tanh)."""
        name = self.feed_forward_proj.split("-")[-1]
        return "gelu_new" if self.feed_forward_proj == "gated-gelu" else name

    @classmethod
    def from_hf(cls, cfg: dict) -> "T5Config":
        return cls(
            vocab_size=cfg["vocab_size"], d_model=cfg["d_model"], d_kv=cfg["d_kv"], d_ff=cfg["d_ff"],
            num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
            relative_attention_num_buckets=cfg.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=cfg.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=cfg.get("layer_norm_epsilon", 1e-6),
            feed_forward_proj=cfg.get("feed_forward_proj", "relu"), model_type=cfg.get("model_type", "t5"),
        )


# UMT5-XXL, Wan 2.1's text encoder: Hugging Face `google/umt5-xxl`, config.json.
UMT5_XXL_CONFIG = dict(
    vocab_size=256384, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
    relative_attention_num_buckets=32, relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
    feed_forward_proj="gated-gelu", model_type="umt5",
)
# T5-XXL v1.1, LTX-Video's (and CogVideoX's) text encoder: Hugging Face `google/t5-v1_1-xxl`, config.json.
T5_V1_1_XXL_CONFIG = dict(
    vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
    relative_attention_num_buckets=32, relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
    feed_forward_proj="gated-gelu", model_type="t5",
)


def t5_relative_buckets(q_len: int, k_len: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """(q_len, k_len) bidirectional buckets of key position - query position
    (transformers' `_relative_position_bucket`), computed on the CPU in fp32 so
    every device indexes the same table entries."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).long() * half
    rel = rel.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
                         * (half - max_exact)).long()
    large = torch.clamp(large, max=half - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


def _t5_act(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu":
        return F.gelu
    if name == "silu":
        return F.silu
    raise ValueError(f"Unknown T5 activation {name!r}")


class _T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype, has_relative_attention_bias: bool) -> None:
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        for name, (i, o) in dict(q=(cfg.d_model, inner), k=(cfg.d_model, inner), v=(cfg.d_model, inner),
                                 o=(inner, cfg.d_model)).items():
            setattr(self, name, LoRADense(i, o, bias=False, dtype=dtype))
        if has_relative_attention_bias:
            self.relative_attention_bias = Embedding(cfg.relative_attention_num_buckets, cfg.num_heads, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Plain fp32 attention with no 1/sqrt(d) scale, `bias` (B or 1, N, S, S)
        the relative bias plus the padded keys' additive mask, as Flax computes it."""
        b, s, _ = x.shape
        q, k, v = (proj(x).reshape(b, s, self.num_heads, self.d_kv).transpose(1, 2).float()
                   for proj in (self.q, self.k, self.v))
        probs = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        out = (probs @ v).transpose(1, 2).reshape(b, s, self.num_heads * self.d_kv)
        return self.o(out.to(self.o.compute_dtype))


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype, has_relative_attention_bias: bool) -> None:
        super().__init__()
        self.SelfAttention = _T5Attention(cfg, dtype, has_relative_attention_bias)
        self.layer_norm = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon, dtype=dtype)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class _T5DenseReluDense(nn.Module):
    """`DenseReluDense`: wi -> act -> wo, or with a gated projection act(wi_0) * wi_1 -> wo."""

    def __init__(self, cfg: T5Config, dtype: torch.dtype) -> None:
        super().__init__()
        self.gated = cfg.is_gated
        if self.gated:
            self.wi_0 = LoRADense(cfg.d_model, cfg.d_ff, bias=False, dtype=dtype)
            self.wi_1 = LoRADense(cfg.d_model, cfg.d_ff, bias=False, dtype=dtype)
        else:
            self.wi = LoRADense(cfg.d_model, cfg.d_ff, bias=False, dtype=dtype)
        self.wo = LoRADense(cfg.d_ff, cfg.d_model, bias=False, dtype=dtype)
        self.act = _t5_act(cfg.act)

    def forward(self, x):
        if self.gated:
            return self.wo(self.act(self.wi_0(x)) * self.wi_1(x))
        return self.wo(self.act(self.wi(x)))


class _T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype) -> None:
        super().__init__()
        self.DenseReluDense = _T5DenseReluDense(cfg, dtype)
        self.layer_norm = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon, dtype=dtype)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype, has_relative_attention_bias: bool) -> None:
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerSelfAttention(cfg, dtype, has_relative_attention_bias),
                                    _T5LayerFF(cfg, dtype)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype) -> None:
        super().__init__()
        self.block = nn.ModuleList([_T5Block(cfg, dtype, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, eps=cfg.layer_norm_epsilon, dtype=dtype)


class T5EncoderTower(nn.Module):
    """T5EncoderModel as transformers' Flax T5 computes it (`FlaxT5EncoderModel`):
    `forward(input_ids, attention_mask)` -> the last hidden state. One relative
    bias, from layer 0's table, is added in every layer, with the padded keys
    masked by adding float32's lowest value; the norms are RMS without the
    mean, with fp32 statistics. The attention is plain torch math in fp32: K1
    takes no additive bias, and JAX's runs in XLA, not in a Pallas kernel."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config = config
        self.shared = Embedding(config.vocab_size, config.d_model, dtype)
        self.encoder = _T5Stack(config, dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        s = input_ids.shape[1]
        buckets = t5_relative_buckets(s, s, cfg.relative_attention_num_buckets,
                                      cfg.relative_attention_max_distance).to(input_ids.device)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        bias = table(buckets).float().permute(2, 0, 1)[None]  # (1, N, S, S)
        if attention_mask is not None:
            keep = attention_mask.to(device=input_ids.device)[:, None, None, :] > 0
            bias = bias + torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        x = self.shared(input_ids)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
