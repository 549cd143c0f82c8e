"""CogView4 image DiT in PyTorch (port of `finetrainers_tpu/models/cogview4/transformer.py`).

Structure: 2x2 patches of the latents and the GLM text states, each
projected to the model width; 28 blocks over the joint [text, image] stream,
each with one 12-way adaLN modulation (shift, scale, gate for the image and
the text stream, before the attention and before the feed-forward),
affine-free LayerNorms, q/k/v over the joined stream with per-head affine
LayerNorms on q and k before the rotation, one joint self-attention with no
mask (the padded text slots are keys for every query, as in JAX :74), and a
GELU-tanh feed-forward over the joined stream; then the adaLN out (shift,
scale) and `proj_out`, fp32 out. Conditioned on the timestep and SDXL's
size/crop microconditioning (each a sinusoidal embedding; zeros stand in
for a size that is not given, JAX :140). 2D RoPE over the image patches
(`axial_rope_freqs(128, (ph, pw), (0.5, 0.5))`), one fp32 (S, head_dim)
table pair for the joint sequence whose text rows are the identity (JAX
:69-73). Module and parameter names are diffusers' `CogView4Transformer2DModel`
names, the ones `cogview4_key_map` gives the JAX package's flax names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention_dispatch
from ..layers import FeedForward, LayerNorm, LoRADense, axial_rope_freqs, block_stack, sinusoidal_timestep_embedding


def cogview4_rope_tables(text_len: int, ph: int, pw: int, head_dim: int,
                         device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (text_len + ph * pw, head_dim) fp32 (cos, sin) pair of the joint
    sequence: the identity on the text rows, then the image patches' 2D RoPE
    repeated in pairs (JAX :149, :69-73)."""
    cos, sin = axial_rope_freqs(head_dim, (ph, pw), (0.5, 0.5), device=device)
    cos2, sin2 = cos.repeat_interleave(2, dim=-1), sin.repeat_interleave(2, dim=-1)
    return (torch.cat([torch.ones((text_len, head_dim), dtype=cos2.dtype, device=device), cos2]),
            torch.cat([torch.zeros((text_len, head_dim), dtype=sin2.dtype, device=device), sin2]))


class _AdaLN(nn.Module):
    """`adaln.linear`: silu(temb) -> 12 modulation rows of `dim`."""

    def __init__(self, time_embed_dim: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear = LoRADense(time_embed_dim, 12 * dim, dtype=dtype)

    def forward(self, temb: torch.Tensor):
        return [m[:, None] for m in self.linear(F.silu(temb)).chunk(12, dim=-1)]


class CogView4Attention(nn.Module):
    """`attn1`: q/k/v over the joined stream, per-head affine LayerNorms on q
    and k, and the out projection `to_out.0`."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, **kw) -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q, self.to_k, self.to_v = (LoRADense(dim, inner, **kw) for _ in range(3))
        self.norm_q = LayerNorm(head_dim, elementwise_affine=True, dtype=kw["dtype"])
        self.norm_k = LayerNorm(head_dim, elementwise_affine=True, dtype=kw["dtype"])
        self.to_out = nn.ModuleList([LoRADense(inner, dim, **kw)])

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        b, s = x.shape[:2]
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.norm_q(self.to_q(x).reshape(shape))
        k = self.norm_k(self.to_k(x).reshape(shape))
        v = self.to_v(x).reshape(shape)
        out = attention_dispatch(q, k, v, rope_freqs=rope).reshape(b, s, -1)
        return self.to_out[0](out)


class CogView4Block(nn.Module):
    """One block (JAX :38-90). `carry` is (image, text)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, time_embed_dim: int, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        self.adaln = _AdaLN(time_embed_dim, dim, dtype)
        self.ln = LayerNorm(dim, dtype=dtype)  # norm1, norm1_context, norm2, norm2_context: no parameters
        self.attn1 = CogView4Attention(dim, num_heads, head_dim, **kw)
        self.ff = FeedForward(dim, 4 * dim, **kw)

    def forward(self, carry, temb, rope):
        hidden, encoder_hidden = carry
        st = encoder_hidden.shape[1]
        (shift, scale, gate, enc_shift, enc_scale, enc_gate,
         shift2, scale2, gate2, enc_shift2, enc_scale2, enc_gate2) = self.adaln(temb)
        h = self.ln(hidden) * (1 + scale) + shift
        e = self.ln(encoder_hidden) * (1 + enc_scale) + enc_shift
        attn = self.attn1(torch.cat([e, h], dim=1), rope)
        encoder_hidden = encoder_hidden + enc_gate * attn[:, :st]
        hidden = hidden + gate * attn[:, st:]

        h = self.ln(hidden) * (1 + scale2) + shift2
        e = self.ln(encoder_hidden) * (1 + enc_scale2) + enc_shift2
        x = self.ff(torch.cat([e, h], dim=1))
        encoder_hidden = encoder_hidden + enc_gate2 * x[:, :st]
        hidden = hidden + gate2 * x[:, st:]
        return hidden, encoder_hidden


class _PatchEmbed(nn.Module):
    def __init__(self, in_features: int, text_embed_dim: int, inner: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.proj = LoRADense(in_features, inner, dtype=dtype)
        self.text_proj = LoRADense(text_embed_dim, inner, dtype=dtype)


class _LinearPair(nn.Module):
    def __init__(self, in_features: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = LoRADense(in_features, dim, dtype=dtype)
        self.linear_2 = LoRADense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class _TimeConditionEmbed(nn.Module):
    def __init__(self, in_features: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.timestep_embedder = _LinearPair(in_features, dim, dtype)


class _NormOut(nn.Module):
    """silu(temb) -> (shift, scale), in that order (JAX :166-168)."""

    def __init__(self, time_embed_dim: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear = LoRADense(time_embed_dim, 2 * dim, dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        shift, scale = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/p * W/p, C*p*p), (c, p, p) order per patch (JAX :127-129)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def unpatchify(x: torch.Tensor, p: int, channels: int, h: int, w: int) -> torch.Tensor:
    """The inverse of `patchify` (JAX :171-172)."""
    b = x.shape[0]
    x = x.reshape(b, h // p, w // p, channels, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, channels, h, w)


class CogView4Transformer2DModel(nn.Module):
    def __init__(self, in_channels: int = 16, out_channels: int = 16, patch_size: int = 2,
                 num_attention_heads: int = 32, attention_head_dim: int = 128, num_layers: int = 28,
                 text_embed_dim: int = 4096, time_embed_dim: int = 512, condition_dim: int = 256,
                 lora_rank: int = 0, lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: Optional[str] = None) -> None:
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.dtype = dtype
        self.patch_size = patch_size
        self.out_channels = out_channels
        self.head_dim = attention_head_dim
        self.condition_dim = condition_dim
        # Per-block remat policy (None or a type of CHECKPOINT_TYPES), read by block_stack.
        self.gradient_checkpointing = gradient_checkpointing
        self.patch_embed = _PatchEmbed(in_channels * patch_size**2, text_embed_dim, inner, dtype)
        self.time_condition_embed = _TimeConditionEmbed(7 * condition_dim, time_embed_dim, dtype)
        self.transformer_blocks = nn.ModuleList([
            CogView4Block(inner, num_attention_heads, attention_head_dim, time_embed_dim, lora_rank=lora_rank,
                          lora_alpha=lora_alpha, dtype=dtype) for _ in range(num_layers)])
        self.norm_out = _NormOut(time_embed_dim, inner, dtype)
        self.proj_out = LoRADense(inner, out_channels * patch_size**2, dtype=dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, C, H, W)
        encoder_hidden_states: torch.Tensor,  # (B, L, text_embed_dim)
        timestep: torch.Tensor,  # (B,)
        original_size: Optional[torch.Tensor] = None,  # (B, 2)
        target_size: Optional[torch.Tensor] = None,  # (B, 2)
        crop_coords: Optional[torch.Tensor] = None,  # (B, 2)
    ) -> torch.Tensor:
        b, _, h, w = hidden_states.shape
        p = self.patch_size
        x = self.patch_embed.proj(patchify(hidden_states, p).to(self.dtype))
        context = self.patch_embed.text_proj(encoder_hidden_states.to(self.dtype))

        parts = [sinusoidal_timestep_embedding(timestep.float(), self.condition_dim)]
        for tensor in (original_size, target_size, crop_coords):
            if tensor is None:
                tensor = torch.zeros((b, 2), dtype=torch.float32, device=x.device)
            parts.append(sinusoidal_timestep_embedding(tensor.reshape(-1).float(), self.condition_dim).reshape(b, -1))
        temb = self.time_condition_embed.timestep_embedder(torch.cat(parts, dim=-1).to(self.dtype))

        rope = cogview4_rope_tables(context.shape[1], h // p, w // p, self.head_dim, device=x.device)
        x, context = block_stack(self.transformer_blocks, (x, context), temb, rope,
                                 checkpoint=self.gradient_checkpointing)
        x = self.proj_out(self.norm_out(x, temb))
        return unpatchify(x, p, self.out_channels, h, w).float()
