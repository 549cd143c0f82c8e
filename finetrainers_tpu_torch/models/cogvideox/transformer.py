"""CogVideoX DiT in PyTorch (port of `finetrainers_tpu/models/cogvideox/transformer.py`).

Latents are frames-first, (B, F, C, H, W). Structure: patches of 2x2 per frame
(1.0) or of `patch_size_t` frames x 2 x 2 (1.5), each in (pt, c, p, p)
order; the T5 states projected to the model width; with the 2B config a
learned positional embedding added to both streams (text rows from 0, video
rows from 226); the timestep's sinusoidal embedding (and with `ofs_embed_dim`
the `ofs` one) through two linears. Each block over the joint [text, video]
stream: `norm1` (one linear of silu(temb) -> shift, scale and gate for the
video and for the text stream, affine-free LayerNorms), q/k/v with per-head
affine LayerNorms on q and k, one joint self-attention with no mask (the
padded text slots are keys, JAX :106), `norm2` and a GELU-tanh feed-forward
over the joined stream. Then an affine LayerNorm (`norm_final`), the adaLN out
and `proj_out`, fp32 out. With the 5B config a 3D RoPE over (frame, row, col),
`axial_rope_freqs(head_dim, (F, H, W), (0.25, 0.375, 0.375))` as interleaved
pairs, one fp32 (S, head_dim) table pair for the joint sequence whose 226
text rows are the identity (JAX :99-109), rotated inside K1's pre-pass.

Module and parameter names are the ones `cogvideox_key_map` gives the JAX
package's flax names (diffusers' `CogVideoXTransformer3DModel` names).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..cogview4.transformer import CogView4Attention, _LinearPair, _NormOut
from ..layers import FeedForward, LayerNorm, LoRADense, axial_rope_freqs, block_stack, sinusoidal_timestep_embedding


def cogvideox_rope_tables(text_len: int, frames: int, rows: int, cols: int, head_dim: int,
                          device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (text_len + frames * rows * cols, head_dim) fp32 (cos, sin) pair of
    the joint sequence: the identity on the text rows, then the patches' 3D
    RoPE repeated in pairs (JAX :34-40, :99-109)."""
    cos, sin = axial_rope_freqs(head_dim, (frames, rows, cols), (0.25, 0.375, 0.375), device=device)
    cos2, sin2 = cos.repeat_interleave(2, dim=-1), sin.repeat_interleave(2, dim=-1)
    return (torch.cat([torch.ones((text_len, head_dim), dtype=cos2.dtype, device=device), cos2]),
            torch.cat([torch.zeros((text_len, head_dim), dtype=sin2.dtype, device=device), sin2]))


class CogVideoXLayerNormZero(nn.Module):
    """silu(temb) -> (shift, scale, gate) for the video and for the text
    stream from one linear; affine-free LayerNorms, then the modulation (JAX :51-68)."""

    def __init__(self, time_embed_dim: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear = LoRADense(time_embed_dim, 6 * dim, dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)  # `norm` and `norm_enc` in JAX: no parameters

    def forward(self, hidden: torch.Tensor, encoder_hidden: torch.Tensor, temb: torch.Tensor):
        shift, scale, gate, enc_shift, enc_scale, enc_gate = (
            m[:, None] for m in self.linear(F.silu(temb)).chunk(6, dim=-1))
        h = self.norm(hidden) * (1 + scale) + shift
        e = self.norm(encoder_hidden) * (1 + enc_scale) + enc_shift
        return h, e, gate, enc_gate


class CogVideoXBlock(nn.Module):
    """One block (JAX :71-130). `carry` is (video, text)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, time_embed_dim: int, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        self.norm1 = CogVideoXLayerNormZero(time_embed_dim, dim, dtype)
        self.attn1 = CogView4Attention(dim, num_heads, head_dim, **kw)
        self.norm2 = CogVideoXLayerNormZero(time_embed_dim, dim, dtype)
        self.ff = FeedForward(dim, 4 * dim, **kw)

    def forward(self, carry, temb, rope):
        hidden, encoder_hidden = carry
        st = encoder_hidden.shape[1]
        h, e, gate, enc_gate = self.norm1(hidden, encoder_hidden, temb)
        attn = self.attn1(torch.cat([e, h], dim=1), rope)
        hidden = hidden + gate * attn[:, st:]
        encoder_hidden = encoder_hidden + enc_gate * attn[:, :st]

        h, e, gate, enc_gate = self.norm2(hidden, encoder_hidden, temb)
        x = self.ff(torch.cat([e, h], dim=1))
        hidden = hidden + gate * x[:, st:]
        encoder_hidden = encoder_hidden + enc_gate * x[:, :st]
        return hidden, encoder_hidden


class _PatchEmbed(nn.Module):
    """`proj`, `text_proj` and, for the 2B config, the fp32 `pos_embedding` (1, max_tokens, inner)."""

    def __init__(self, in_features: int, text_embed_dim: int, inner: int, max_tokens: Optional[int],
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.proj = LoRADense(in_features, inner, dtype=dtype)
        self.text_proj = LoRADense(text_embed_dim, inner, dtype=dtype)
        self.pos_embedding = (nn.Parameter(torch.empty(1, max_tokens, inner, dtype=torch.float32))
                              if max_tokens else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.pos_embedding is not None:
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 0.02, generator=generator)


def patchify(x: torch.Tensor, p: int, pt: int) -> torch.Tensor:
    """(B, F, C, H, W) -> (B, F/pt * H/p * W/p, pt * C * p * p), each patch in (pt, c, p, p) order (JAX :173-174)."""
    b, f, c, h, w = x.shape
    x = x.reshape(b, f // pt, pt, c, h // p, p, w // p, p).permute(0, 1, 4, 6, 2, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // p) * (w // p), pt * c * p * p)


def unpatchify(x: torch.Tensor, shape: Tuple[int, int, int], channels: int, p: int, pt: int) -> torch.Tensor:
    """The inverse of `patchify` for a (F, H, W) latent of `channels` (JAX :228-229)."""
    b = x.shape[0]
    f, h, w = shape
    x = x.reshape(b, f // pt, h // p, w // p, pt, channels, p, p).permute(0, 1, 4, 5, 2, 6, 3, 7)
    return x.reshape(b, f, channels, h, w)


class CogVideoXTransformer3DModel(nn.Module):
    def __init__(self, in_channels: int = 16, out_channels: int = 16, patch_size: int = 2,
                 patch_size_t: Optional[int] = None, num_attention_heads: int = 30, attention_head_dim: int = 64,
                 num_layers: int = 30, text_embed_dim: int = 4096, time_embed_dim: int = 512,
                 max_text_seq_length: int = 226, sample_frames: int = 49, sample_height: int = 60,
                 sample_width: int = 90, use_rotary_positional_embeddings: bool = False,
                 use_learned_positional_embeddings: bool = True, ofs_embed_dim: Optional[int] = None,
                 lora_rank: int = 0, lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: Optional[str] = None) -> None:
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.dtype = dtype
        self.out_channels = out_channels
        self.patch_size, self.patch_size_t = patch_size, patch_size_t or 1
        self.head_dim = attention_head_dim
        self.inner = inner
        self.max_text_seq_length = max_text_seq_length
        self.use_rope = use_rotary_positional_embeddings
        self.ofs_embed_dim = ofs_embed_dim
        # Per-block remat policy (None or a type of CHECKPOINT_TYPES), read by block_stack.
        self.gradient_checkpointing = gradient_checkpointing
        max_tokens = None
        if use_learned_positional_embeddings and not use_rotary_positional_embeddings:
            max_tokens = max_text_seq_length + (sample_frames // 4 + 1) * (sample_height // patch_size) * (
                sample_width // patch_size)
        self.patch_embed = _PatchEmbed(in_channels * self.patch_size_t * patch_size**2, text_embed_dim, inner,
                                       max_tokens, dtype)
        self.time_embedding = _LinearPair(inner, time_embed_dim, dtype)
        if ofs_embed_dim is not None:
            self.ofs_embedding = _LinearPair(ofs_embed_dim, time_embed_dim, dtype)
        self.transformer_blocks = nn.ModuleList([
            CogVideoXBlock(inner, num_attention_heads, attention_head_dim, time_embed_dim, lora_rank=lora_rank,
                           lora_alpha=lora_alpha, dtype=dtype) for _ in range(num_layers)])
        self.norm_final = LayerNorm(inner, elementwise_affine=True, dtype=dtype)
        self.norm_out = _NormOut(time_embed_dim, inner, dtype)
        self.proj_out = LoRADense(inner, out_channels * self.patch_size_t * patch_size**2, dtype=dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, F, C, H, W), frames first
        encoder_hidden_states: torch.Tensor,  # (B, L, text_embed_dim)
        timestep: torch.Tensor,  # (B,)
        ofs: Optional[torch.Tensor] = None,  # (B,)
    ) -> torch.Tensor:
        f, _, h, w = hidden_states.shape[1:]
        p, pt = self.patch_size, self.patch_size_t
        x = self.patch_embed.proj(patchify(hidden_states, p, pt).to(self.dtype))
        context = self.patch_embed.text_proj(encoder_hidden_states.to(self.dtype))
        st = context.shape[1]
        pos = self.patch_embed.pos_embedding
        if pos is not None:
            context = context + pos[:, :st].to(self.dtype)
            x = x + pos[:, self.max_text_seq_length:self.max_text_seq_length + x.shape[1]].to(self.dtype)

        temb = self.time_embedding(sinusoidal_timestep_embedding(timestep.float(), self.inner).to(self.dtype))
        if self.ofs_embed_dim is not None and ofs is not None:
            temb = temb + self.ofs_embedding(
                sinusoidal_timestep_embedding(ofs.float(), self.ofs_embed_dim).to(self.dtype))

        rope = None
        if self.use_rope:
            rope = cogvideox_rope_tables(st, f // pt, h // p, w // p, self.head_dim, device=x.device)
        x, context = block_stack(self.transformer_blocks, (x, context), temb, rope,
                                 checkpoint=self.gradient_checkpointing)
        # JAX normalises the joined stream and keeps the video rows: the LayerNorm is per token.
        x = self.proj_out(self.norm_out(self.norm_final(x), temb))
        return unpatchify(x, (f, h, w), self.out_channels, p, pt).float()
