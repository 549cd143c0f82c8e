"""HunyuanVideo DiT in PyTorch (port of `finetrainers_tpu/models/hunyuan_video/transformer.py`).

Structure: (1, 2, 2) patches of the latent video in (c, pt, p, p) order; a
2-block token refiner over the Llama prompt states (self-attention with
`kv_lens` and no RoPE, gated by the timestep and the refiner's mean over the
valid tokens); 20 dual-stream and 40 single-stream blocks, which are the Flux
blocks (`models/flux/transformer.py`), over [text, video] with one joint
attention each; the continuous adaLN out and `proj_out`, fp32 out.
Conditioned on the timestep, the CLIP pooled text and the guidance (6.0 x
1000 when none is given). RoPE over (frame, row, col) ids with axes dims (16,
56, 56): one fp32 (S, head_dim) table pair for the joint sequence, shared by
every head and the batch; the text ids are zero, so the text rows are the
identity. The joint attention takes no mask, so the padded text slots take
part as keys, as in JAX (ROADMAP.md section 3, finding 15).

Module and parameter names give the keys `export_hunyuan_transformer_state_dict`
(JAX weights.py:34) writes: diffusers' `HunyuanVideoTransformer3DModel` names,
but for the refiner blocks, which JAX exports as `refiner_blocks_<i>`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention_dispatch
from ..flux.transformer import (AdaLayerNormZero, FluxDualBlock, FluxSingleBlock, _LinearPair, _NormOut,
                                _TimeTextEmbed, flux_rope_freqs, rope_tables)
from ..layers import LayerNorm, LoRADense, block_stack, sinusoidal_timestep_embedding


class _RefinerAttention(nn.Module):
    def __init__(self, dim: int, **kw) -> None:
        super().__init__()
        self.to_q, self.to_k, self.to_v = (LoRADense(dim, dim, **kw) for _ in range(3))
        self.to_out = nn.ModuleList([LoRADense(dim, dim, **kw)])


class _SiLUProjection(nn.Module):
    def __init__(self, dim: int, inner: int, **kw) -> None:
        super().__init__()
        self.proj = LoRADense(dim, inner, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.proj(x))


class _RefinerFeedForward(nn.Module):
    """net.0.proj -> silu -> net.2, `dim` -> 4 `dim` -> `dim` (JAX :61-64)."""

    def __init__(self, dim: int, **kw) -> None:
        super().__init__()
        self.net = nn.ModuleList([_SiLUProjection(dim, 4 * dim, **kw), nn.Identity(), LoRADense(4 * dim, dim, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TokenRefinerBlock(nn.Module):
    """Self-attention block over the text tokens, gated by the refiner's
    conditioning (JAX :32-66): affine LayerNorms, q/k/v/out with LoRA,
    attention with `kv_lens` and no tables, a SiLU feed-forward."""

    def __init__(self, dim: int, num_heads: int, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        self.num_heads = num_heads
        self.norm_out = AdaLayerNormZero(dim, n=2, dtype=dtype)  # silu(cond) -> (gate_attn, gate_mlp), no LoRA
        self.norm1 = LayerNorm(dim, elementwise_affine=True, dtype=dtype)
        self.attn = _RefinerAttention(dim, **kw)
        self.norm2 = LayerNorm(dim, elementwise_affine=True, dtype=dtype)
        self.ff = _RefinerFeedForward(dim, **kw)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, dim = x.shape
        gate_attn, gate_mlp = self.norm_out(cond)
        h = self.norm1(x)
        q, k, v = (proj(h).reshape(b, s, self.num_heads, dim // self.num_heads)
                   for proj in (self.attn.to_q, self.attn.to_k, self.attn.to_v))
        attn = attention_dispatch(q, k, v, kv_lens=kv_lens).reshape(b, s, dim)
        x = x + self.attn.to_out[0](attn) * gate_attn
        return x + self.ff(self.norm2(x)) * gate_mlp


class _TokenRefiner(nn.Module):
    """The refiner's blocks, named `refiner_blocks_<i>` as JAX exports them."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, **kw) -> None:
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"refiner_blocks_{i}", TokenRefinerBlock(dim, num_heads, **kw))

    def forward(self, x: torch.Tensor, cond: torch.Tensor, kv_lens: Optional[torch.Tensor]) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"refiner_blocks_{i}")(x, cond, kv_lens)
        return x


class _ContextEmbedder(nn.Module):
    """`proj_in`, the refiner's conditioning and its blocks (JAX :132-150)."""

    def __init__(self, text_embed_dim: int, dim: int, num_heads: int, num_layers: int, lora_rank: int,
                 lora_alpha: float, dtype: torch.dtype) -> None:
        super().__init__()
        self.proj_in = LoRADense(text_embed_dim, dim, dtype=dtype)
        self.time_text_embed = _TimeTextEmbed(dim, dim, False, dtype)  # the timestep's and the pooled text's
        self.token_refiner = _TokenRefiner(num_layers, dim, num_heads, lora_rank=lora_rank, lora_alpha=lora_alpha,
                                           dtype=dtype)


def kv_lens_from_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The refiner's int32 `kv_lens`: a (B, L) mask's row sums, or a (B,) mask
    taken as the lengths themselves (JAX :135-138)."""
    if mask is None:
        return None
    return mask.to(torch.int32).sum(dim=1, dtype=torch.int32) if mask.ndim == 2 else mask.to(torch.int32)


def video_ids(frames: int, rows: int, cols: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """(F * H * W, 3) fp32 (frame, row, col) ids of the patched video, row-major (JAX :159-162)."""
    grid = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=device) for n in (frames, rows, cols)),
                          indexing="ij")
    return torch.stack([g.reshape(-1) for g in grid], dim=-1)


def patchify(x: torch.Tensor, p: int, pt: int) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, F/pt * H/p * W/p, C * pt * p * p), each patch in (c, pt, p, p) order (JAX :113-115)."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f // pt, pt, h // p, p, w // p, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // p) * (w // p), c * pt * p * p)


def unpatchify(x: torch.Tensor, shape: Tuple[int, int, int], channels: int, p: int, pt: int) -> torch.Tensor:
    """The inverse of `patchify` for a (F, H, W) latent of `channels` (JAX :200-201)."""
    b = x.shape[0]
    f, h, w = shape
    x = x.reshape(b, f // pt, h // p, w // p, channels, pt, p, p).permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, channels, f, h, w)


class HunyuanVideoTransformer3DModel(nn.Module):
    def __init__(self, in_channels: int = 16, out_channels: int = 16, patch_size: int = 2, patch_size_t: int = 1,
                 num_attention_heads: int = 24, attention_head_dim: int = 128, num_layers: int = 20,
                 num_single_layers: int = 40, num_refiner_layers: int = 2, text_embed_dim: int = 4096,
                 pooled_projection_dim: int = 768, guidance_embeds: bool = True,
                 rope_axes_dim: Tuple[int, ...] = (16, 56, 56), lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, gradient_checkpointing: Optional[str] = None) -> None:
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        if sum(rope_axes_dim) != attention_head_dim:
            raise ValueError(f"rope_axes_dim {rope_axes_dim} must sum to the head dim {attention_head_dim}")
        self.dtype = dtype
        self.out_channels = out_channels
        self.patch_size, self.patch_size_t = patch_size, patch_size_t
        self.guidance_embeds = guidance_embeds
        self.rope_axes_dim = tuple(rope_axes_dim)
        # Per-block remat policy of the 60 blocks (None or a type of CHECKPOINT_TYPES), read by block_stack.
        # The refiner is not in a block stack, so no policy touches it, as in JAX.
        self.gradient_checkpointing = gradient_checkpointing
        patch = in_channels * patch_size_t * patch_size * patch_size
        self.x_embedder = LoRADense(patch, inner, dtype=dtype)
        self.time_text_embed = _TimeTextEmbed(inner, pooled_projection_dim, guidance_embeds, dtype)
        self.context_embedder = _ContextEmbedder(text_embed_dim, inner, num_attention_heads, num_refiner_layers,
                                                 lora_rank, lora_alpha, dtype)
        block_kw = dict(dim=inner, num_heads=num_attention_heads, head_dim=attention_head_dim, lora_rank=lora_rank,
                        lora_alpha=lora_alpha, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([FluxDualBlock(**block_kw) for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList([FluxSingleBlock(**block_kw)
                                                        for _ in range(num_single_layers)])
        self.norm_out = _NormOut(inner, dtype)
        self.proj_out = LoRADense(inner, out_channels * patch_size_t * patch_size * patch_size, dtype=dtype)

    def _embed(self, pair: _LinearPair, t: torch.Tensor) -> torch.Tensor:
        return pair(sinusoidal_timestep_embedding(t.float(), 256).to(self.dtype))

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, C, F, H, W)
        encoder_hidden_states: torch.Tensor,  # (B, L, text_embed_dim), the Llama states
        timestep: torch.Tensor,  # (B,) in [0, 1] * 1000
        pooled_projections: torch.Tensor,  # (B, pooled_projection_dim), the CLIP pooled states
        encoder_attention_mask: Optional[torch.Tensor] = None,  # (B, L), or (B,) lengths
        guidance: Optional[torch.Tensor] = None,  # (B,)
    ) -> torch.Tensor:
        p, pt = self.patch_size, self.patch_size_t
        f, h, w = hidden_states.shape[2:]
        x = self.x_embedder(patchify(hidden_states, p, pt).to(self.dtype))

        emb = self.time_text_embed
        temb = self._embed(emb.timestep_embedder, timestep)
        if self.guidance_embeds:
            g = guidance if guidance is not None else torch.full_like(timestep, 6.0) * 1000.0
            temb = temb + self._embed(emb.guidance_embedder, g)
        temb = temb + emb.text_embedder(pooled_projections.to(self.dtype))

        ctx = self.context_embedder
        txt = ctx.proj_in(encoder_hidden_states.to(self.dtype))
        kv_lens = kv_lens_from_mask(encoder_attention_mask)
        if kv_lens is not None:
            token_mask = (torch.arange(txt.shape[1], device=txt.device)[None, :] < kv_lens[:, None]).to(txt.dtype)
            token_mask = token_mask[..., None]
            ctx_pool = (txt * token_mask).sum(dim=1) / token_mask.sum(dim=1).clamp_min(1.0)
        else:
            ctx_pool = txt.mean(dim=1)
        refine_cond = self._embed(ctx.time_text_embed.timestep_embedder, timestep) \
            + ctx.time_text_embed.text_embedder(ctx_pool)
        txt = ctx.token_refiner(txt, refine_cond, kv_lens)

        ids = torch.cat([torch.zeros((txt.shape[1], 3), device=x.device),
                         video_ids(f // pt, h // p, w // p, x.device)])
        rope = rope_tables(*flux_rope_freqs(ids, self.rope_axes_dim))

        x, txt = block_stack(self.transformer_blocks, (x, txt), temb, rope, checkpoint=self.gradient_checkpointing)
        full = block_stack(self.single_transformer_blocks, torch.cat([txt, x], dim=1), temb, rope,
                           checkpoint=self.gradient_checkpointing)
        x = self.proj_out(self.norm_out(full[:, txt.shape[1]:], temb))
        return unpatchify(x, (f, h, w), self.out_channels, p, pt).float()
