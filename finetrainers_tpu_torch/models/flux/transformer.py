"""Flux DiT in PyTorch (port of `finetrainers_tpu/models/flux/transformer.py`).

Structure: packed 2x2 latent tokens and T5 text tokens; 19 dual-stream blocks
(separate image and text streams, each with its own adaLN-Zero modulation,
projections and feed-forward, one joint attention over [text, image]), then
38 single-stream blocks over the joined sequence (q/k/v and the MLP read the
same modulated input, one `proj_out` over [attention, MLP]), then the
continuous adaLN out (scale, shift) and `proj_out`, fp32 out. Conditioned on
the timestep, the CLIP pooled text and, for the guidance-distilled
checkpoints, the guidance. RoPE over (id0, row, col) ids with axes dims (16,
56, 56): one fp32 (S, head_dim) table pair for the whole joint sequence,
shared by every head and the batch; text ids are zero, so the text rows are
the identity. Module and parameter names are diffusers'
`FluxTransformer2DModel` names.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention_dispatch
from ..layers import FeedForward, LayerNorm, LoRADense, RMSNorm, ROPE_THETA, block_stack, sinusoidal_timestep_embedding


def flux_rope_angles(ids: torch.Tensor, axes_dims: Sequence[int], theta: float = ROPE_THETA) -> torch.Tensor:
    """ids: (S, n_axes) -> fp32 rotary angles (S, sum(axes_dims)/2), each
    axis's concatenated (transformer.py:35-42)."""
    ids = ids.float()
    parts = []
    for i, adim in enumerate(axes_dims):
        inv = 1.0 / (theta ** (torch.arange(0, adim, 2, dtype=torch.float32, device=ids.device) / adim))
        parts.append(ids[:, i:i + 1] * inv[None, :])
    return torch.cat(parts, dim=-1)


def flux_rope_freqs(ids: torch.Tensor, axes_dims: Sequence[int],
                    theta: float = ROPE_THETA) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of `flux_rope_angles`, (S, sum(axes_dims)/2) each."""
    angles = flux_rope_angles(ids, axes_dims, theta)
    return torch.cos(angles), torch.sin(angles)


def rope_tables(cos: torch.Tensor, sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, H/2) tables -> the repeat-2 (S, H) pair `attention_dispatch` takes
    (`_rope_tables`, transformer.py:45): K1's pre-pass rotates q and k with it."""
    return cos.repeat_interleave(2, dim=-1), sin.repeat_interleave(2, dim=-1)


class AdaLayerNormZero(nn.Module):
    """silu(temb) -> `n` * dim modulation rows (shift, scale, gate, ...)."""

    def __init__(self, dim: int, n: int = 6, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.n = n
        self.linear = LoRADense(dim, n * dim, dtype=dtype)

    def forward(self, temb: torch.Tensor):
        return [m[:, None] for m in self.linear(F.silu(temb)).chunk(self.n, dim=-1)]


class FluxAttention(nn.Module):
    """The q/k/v projections of one stream with per-head RMS norms; with
    `context`, also the text stream's (`add_*_proj`, `norm_added_*`) and its
    out projection `to_add_out`."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context: bool, **kw) -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        dtype = kw["dtype"]
        self.to_q, self.to_k, self.to_v = (LoRADense(dim, inner, **kw) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(head_dim, dtype=dtype), RMSNorm(head_dim, dtype=dtype)
        if context:
            self.to_out = nn.ModuleList([LoRADense(inner, dim, **kw)])
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (LoRADense(dim, inner, **kw) for _ in range(3))
            self.norm_added_q, self.norm_added_k = RMSNorm(head_dim, dtype=dtype), RMSNorm(head_dim, dtype=dtype)
            self.to_add_out = LoRADense(inner, dim, **kw)

    def _qkv(self, x, to_q, to_k, to_v, norm_q, norm_k):
        b, s = x.shape[:2]
        q = norm_q(to_q(x).reshape(b, s, self.num_heads, self.head_dim))
        k = norm_k(to_k(x).reshape(b, s, self.num_heads, self.head_dim))
        return q, k, to_v(x).reshape(b, s, self.num_heads, self.head_dim)

    def image_qkv(self, x):
        return self._qkv(x, self.to_q, self.to_k, self.to_v, self.norm_q, self.norm_k)

    def text_qkv(self, x):
        return self._qkv(x, self.add_q_proj, self.add_k_proj, self.add_v_proj, self.norm_added_q, self.norm_added_k)


def _joint_attention(q, k, v, rope):
    """Attention over the whole sequence with the shared RoPE tables; no mask
    (the text mask never reaches attention, as in JAX :109). (B, S, N*H)."""
    b, s, n, h = q.shape
    return attention_dispatch(q, k, v, rope_freqs=rope).reshape(b, s, n * h)


class FluxDualBlock(nn.Module):
    """Dual-stream block (transformer.py:70): image and text each modulated
    by their own adaLN-Zero, joint attention over [text, image], separate out
    projections and GELU-tanh feed-forwards. `carry` is (image, text)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_ratio: float = 4.0, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        mlp_dim = int(dim * mlp_ratio)
        self.norm1 = AdaLayerNormZero(dim, dtype=dtype)
        self.norm1_context = AdaLayerNormZero(dim, dtype=dtype)
        self.ln = LayerNorm(dim, dtype=dtype)
        self.attn = FluxAttention(dim, num_heads, head_dim, context=True, **kw)
        self.ff = FeedForward(dim, mlp_dim, **kw)
        self.ff_context = FeedForward(dim, mlp_dim, **kw)

    def forward(self, carry, temb, rope):
        img, txt = carry
        st = txt.shape[1]
        shift_i, scale_i, gate_i, shift_im, scale_im, gate_im = self.norm1(temb)
        shift_t, scale_t, gate_t, shift_tm, scale_tm, gate_tm = self.norm1_context(temb)
        qi, ki, vi = self.attn.image_qkv(self.ln(img) * (1 + scale_i) + shift_i)
        qt, kt, vt = self.attn.text_qkv(self.ln(txt) * (1 + scale_t) + shift_t)
        out = _joint_attention(torch.cat([qt, qi], dim=1), torch.cat([kt, ki], dim=1), torch.cat([vt, vi], dim=1),
                               rope)
        img = img + gate_i * self.attn.to_out[0](out[:, st:])
        txt = txt + gate_t * self.attn.to_add_out(out[:, :st])
        img = img + gate_im * self.ff(self.ln(img) * (1 + scale_im) + shift_im)
        txt = txt + gate_tm * self.ff_context(self.ln(txt) * (1 + scale_tm) + shift_tm)
        return img, txt


class FluxSingleBlock(nn.Module):
    """Single-stream block (transformer.py:137): one adaLN-Zero (shift, scale,
    gate), attention and a GELU-tanh MLP from the same modulated input,
    `proj_out` over [attention, MLP]."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_ratio: float = 4.0, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        inner, mlp_dim = num_heads * head_dim, int(dim * mlp_ratio)
        self.norm = AdaLayerNormZero(dim, n=3, dtype=dtype)
        self.ln = LayerNorm(dim, dtype=dtype)
        self.attn = FluxAttention(dim, num_heads, head_dim, context=False, **kw)
        self.proj_mlp = LoRADense(dim, mlp_dim, **kw)
        self.proj_out = LoRADense(inner + mlp_dim, dim, **kw)

    def forward(self, x, temb, rope):
        shift, scale, gate = self.norm(temb)
        x_n = self.ln(x) * (1 + scale) + shift
        attn = _joint_attention(*self.attn.image_qkv(x_n), rope)
        mlp = F.gelu(self.proj_mlp(x_n), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))


class _LinearPair(nn.Module):
    """linear_1 (in -> dim), silu, linear_2 (dim -> dim): diffusers' time,
    guidance and pooled-text embedders."""

    def __init__(self, in_features: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = LoRADense(in_features, dim, dtype=dtype)
        self.linear_2 = LoRADense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class _TimeTextEmbed(nn.Module):
    def __init__(self, dim: int, pooled_dim: int, guidance_embeds: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.timestep_embedder = _LinearPair(256, dim, dtype)
        if guidance_embeds:
            self.guidance_embedder = _LinearPair(256, dim, dtype)
        self.text_embedder = _LinearPair(pooled_dim, dim, dtype)


class _NormOut(nn.Module):
    """AdaLayerNormContinuous: silu(temb) -> (scale, shift), in that order."""

    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear = LoRADense(dim, 2 * dim, dtype=dtype)
        self.ln = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return self.ln(x) * (1 + scale[:, None]) + shift[:, None]


class FluxTransformer2DModel(nn.Module):
    def __init__(self, in_channels: int = 64, num_layers: int = 19, num_single_layers: int = 38,
                 num_attention_heads: int = 24, attention_head_dim: int = 128, pooled_projection_dim: int = 768,
                 joint_attention_dim: int = 4096, guidance_embeds: bool = True,
                 axes_dims_rope: Tuple[int, ...] = (16, 56, 56), lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, gradient_checkpointing: Optional[str] = None) -> None:
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        if sum(axes_dims_rope) != attention_head_dim:
            raise ValueError(f"axes_dims_rope {axes_dims_rope} must sum to the head dim {attention_head_dim}")
        self.dtype = dtype
        self.guidance_embeds = guidance_embeds
        self.axes_dims_rope = tuple(axes_dims_rope)
        # Per-block remat policy (None or a type of CHECKPOINT_TYPES), read by block_stack.
        self.gradient_checkpointing = gradient_checkpointing
        self.x_embedder = LoRADense(in_channels, inner, dtype=dtype)
        self.context_embedder = LoRADense(joint_attention_dim, inner, dtype=dtype)
        self.time_text_embed = _TimeTextEmbed(inner, pooled_projection_dim, guidance_embeds, dtype)
        block_kw = dict(dim=inner, num_heads=num_attention_heads, head_dim=attention_head_dim, lora_rank=lora_rank,
                        lora_alpha=lora_alpha, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([FluxDualBlock(**block_kw) for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList([FluxSingleBlock(**block_kw)
                                                        for _ in range(num_single_layers)])
        self.norm_out = _NormOut(inner, dtype)
        self.proj_out = LoRADense(inner, in_channels, dtype=dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, S_img, in_channels) packed latents
        encoder_hidden_states: torch.Tensor,  # (B, S_txt, joint_attention_dim)
        pooled_projections: torch.Tensor,  # (B, pooled_projection_dim)
        timestep: torch.Tensor,  # (B,) in [0, 1] * 1000
        img_ids: torch.Tensor,  # (S_img, 3)
        txt_ids: torch.Tensor,  # (S_txt, 3)
        guidance: Optional[torch.Tensor] = None,  # (B,)
    ) -> torch.Tensor:
        emb = self.time_text_embed
        img = self.x_embedder(hidden_states.to(self.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(self.dtype))

        t_sin = sinusoidal_timestep_embedding(timestep.float(), 256)
        temb = emb.timestep_embedder(t_sin.to(self.dtype))
        if self.guidance_embeds:
            g = guidance if guidance is not None else torch.full_like(timestep, 3.5) * 1000.0
            temb = temb + emb.guidance_embedder(sinusoidal_timestep_embedding(g.float(), 256).to(self.dtype))
        temb = temb + emb.text_embedder(pooled_projections.to(self.dtype))

        ids = torch.cat([txt_ids, img_ids], dim=0).to(img.device)
        rope = rope_tables(*flux_rope_freqs(ids, self.axes_dims_rope))

        img, txt = block_stack(self.transformer_blocks, (img, txt), temb, rope, checkpoint=self.gradient_checkpointing)
        x = block_stack(self.single_transformer_blocks, torch.cat([txt, img], dim=1), temb, rope,
                        checkpoint=self.gradient_checkpointing)
        img = x[:, txt.shape[1]:]
        return self.proj_out(self.norm_out(img, temb)).float()


def pack_flux_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2 * W/2, C*4) (transformer.py:269)."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_flux_latents(packed: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H/2 * W/2, C*4) -> (B, C, H, W) (transformer.py:277)."""
    b, _, d = packed.shape
    c = d // 4
    x = packed.reshape(b, height // 2, width // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, height, width)


def prepare_latent_image_ids(height: int, width: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """(H/2 * W/2, 3) fp32 ids (0, row, col) of a (height, width) latent (transformer.py:285)."""
    h, w = height // 2, width // 2
    ids = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    ids[..., 1] += torch.arange(h, dtype=torch.float32, device=device)[:, None]
    ids[..., 2] += torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ids.reshape(h * w, 3)
