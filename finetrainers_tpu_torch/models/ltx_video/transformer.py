"""LTX-Video DiT in PyTorch (port of `finetrainers_tpu/models/ltx_video/transformer.py`).

Structure (packed-token stream): proj_in -> [N x block: adaLN(self-attn with
3D RoPE fused into K1 + rms-qk-norm) -> cross-attn (no pre-norm, LTX quirk,
`kv_lens` masking in K1) -> adaLN(MLP)] -> norm_out + modulation -> proj_out.
Per-token (B, S) timesteps are native. Module and parameter names are
diffusers' `LTXVideoTransformer3DModel` names, so its state dict loads strict.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention_dispatch
from ..layers import FeedForward, LoRADense, RMSNorm, block_stack, lora_proj_params, sinusoidal_timestep_embedding


class _TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = LoRADense(256, dim, dtype=dtype)
        self.linear_2 = LoRADense(dim, dim, dtype=dtype)


class _CombinedTimestepEmbeddings(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.timestep_embedder = _TimestepEmbedding(dim, dtype)


class LTXAdaLayerNormSingle(nn.Module):
    """PixArt-style single adaLN: timestep -> (temb 6*dim, embedded_timestep dim).
    Accepts (B,) or per-token (B, S) timesteps."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.emb = _CombinedTimestepEmbeddings(dim, dtype)
        self.linear = LoRADense(dim, 6 * dim, dtype=dtype)

    def forward(self, timestep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = timestep.shape
        emb = sinusoidal_timestep_embedding(timestep.reshape(-1), 256, flip_sin_to_cos=True,
                                            downscale_freq_shift=0.0)
        embedder = self.emb.timestep_embedder
        emb = F.silu(embedder.linear_1(emb.to(self.dtype)))
        embedded_timestep = embedder.linear_2(emb)
        temb = self.linear(F.silu(embedded_timestep))
        return temb.reshape(*shape, 6 * self.dim), embedded_timestep.reshape(*shape, self.dim)


class LTXRotaryPosEmbed(nn.Module):
    """3D RoPE over (frame, row, col) token coordinates with diffusers'
    `LTXVideoRotaryPosEmbed` semantics, computed in numpy float64 (phases reach
    ~1.6e4 rad, where float32 phase rounding perturbs cos/sin by ~1e-2) and
    handed over as fp32 (S, dim) tables. Tables are cached per grid and device."""

    def __init__(self, dim: int, patch_size: int = 1, patch_size_t: int = 1, base_num_frames: int = 20,
                 base_height: int = 2048, base_width: int = 2048, theta: float = 10000.0) -> None:
        super().__init__()
        self.dim = dim
        self.patch_size = patch_size
        self.patch_size_t = patch_size_t
        self.base_num_frames = base_num_frames
        self.base_height = base_height
        self.base_width = base_width
        self.theta = theta
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def numpy_tables(self, num_frames: int, height: int, width: int,
                     rope_interpolation_scale: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
        gf, gh, gw = np.meshgrid(
            np.arange(num_frames, dtype=np.float64),
            np.arange(height, dtype=np.float64),
            np.arange(width, dtype=np.float64),
            indexing="ij",
        )
        grid = np.stack([gf.reshape(-1), gh.reshape(-1), gw.reshape(-1)], axis=-1)  # (S, 3)
        scale = np.asarray(
            [
                rope_interpolation_scale[0] * self.patch_size_t / self.base_num_frames,
                rope_interpolation_scale[1] * self.patch_size / self.base_height,
                rope_interpolation_scale[2] * self.patch_size / self.base_width,
            ],
            np.float64,
        )
        grid = grid * scale[None, :]
        n = self.dim // 6
        freqs = self.theta ** np.linspace(0.0, 1.0, n, dtype=np.float64) * (np.pi / 2.0)
        freqs = freqs[None, None, :] * (grid[:, :, None] * 2.0 - 1.0)  # (S, 3, n)
        freqs = np.swapaxes(freqs, -1, -2).reshape(grid.shape[0], -1)  # (f_k, h_k, w_k) triples
        cos = np.repeat(np.cos(freqs), 2, axis=-1)
        sin = np.repeat(np.sin(freqs), 2, axis=-1)
        pad = self.dim % 6
        if pad:
            cos = np.concatenate([np.ones((cos.shape[0], pad)), cos], axis=-1)
            sin = np.concatenate([np.zeros((sin.shape[0], pad)), sin], axis=-1)
        return cos.astype(np.float32), sin.astype(np.float32)

    def forward(self, num_frames: int, height: int, width: int, rope_interpolation_scale: Sequence[float],
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (num_frames, height, width, tuple(float(s) for s in rope_interpolation_scale), str(device))
        if key not in self._tables:
            cos, sin = self.numpy_tables(num_frames, height, width, rope_interpolation_scale)
            self._tables[key] = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
        return self._tables[key]


class LTXAttention(nn.Module):
    """LTX attention: qk RMS-norm across the full inner dim, biases on q/k/v/out.
    Self-attention runs q/k/v as one fused matmul plus one LoRA-A matmul
    (`lora_proj_params`); RoPE is not applied here but fused into K1 through
    `attention_dispatch(rope_freqs=...)`."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        self.to_q = LoRADense(dim, inner, **kw)
        self.to_k = LoRADense(dim, inner, **kw)
        self.to_v = LoRADense(dim, inner, **kw)
        self.norm_q = RMSNorm(inner, dtype=dtype)
        self.norm_k = RMSNorm(inner, dtype=dtype)
        self.to_out = nn.ModuleList([LoRADense(inner, dim, **kw)])

    def _fused_qkv(self, x: torch.Tensor):
        weight, bias, lora_a, lora_bs = lora_proj_params([self.to_q, self.to_k, self.to_v])
        xc = x.to(self.dtype)
        y = F.linear(xc, weight, bias)
        if lora_a is not None:
            rank = self.to_q.rank
            ya = F.linear(xc, lora_a.to(self.dtype))  # (B, S, 3r)
            deltas = [F.linear(ya[..., i * rank:(i + 1) * rank], b.to(self.dtype)) for i, b in enumerate(lora_bs)]
            y = y + self.to_q.scaling * torch.cat(deltas, dim=-1).to(y.dtype)
        return y.chunk(3, dim=-1)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, freqs=None,
                kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, sq = x.shape[0], x.shape[1]
        if context is None:
            q, k, v = self._fused_qkv(x)
        else:
            q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        skv = k.shape[1]
        q = self.norm_q(q).reshape(b, sq, self.num_heads, self.head_dim)
        k = self.norm_k(k).reshape(b, skv, self.num_heads, self.head_dim)
        v = v.reshape(b, skv, self.num_heads, self.head_dim)
        out = attention_dispatch(q, k, v, kv_lens=kv_lens, rope_freqs=freqs)
        return self.to_out[0](out.reshape(b, sq, self.num_heads * self.head_dim))


class LTXTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, dtype=torch.float32))
        self.norm1 = RMSNorm(dim, elementwise_affine=False, dtype=dtype)
        self.attn1 = LTXAttention(dim, num_heads, head_dim, lora_rank, lora_alpha, dtype)
        self.attn2 = LTXAttention(dim, num_heads, head_dim, lora_rank, lora_alpha, dtype)
        self.norm2 = RMSNorm(dim, elementwise_affine=False, dtype=dtype)
        self.ff = FeedForward(dim, 4 * dim, rank=lora_rank, alpha=lora_alpha, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale_shift_table.normal_(0.0, self.dim**-0.5, generator=generator)

    def forward(self, x, context, temb, freqs, encoder_kv_lens=None):
        # scale_shift_table (6, dim) + temb (B, S|1, 6*dim): each modulation is
        # added in fp32, then cast (transformer.py:205-210).
        t6 = temb.reshape(temb.shape[0], -1, 6, self.dim)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = [
            (self.scale_shift_table[i][None, None] + t6[:, :, i].float()).to(self.dtype) for i in range(6)
        ]
        h = self.norm1(x) * (1.0 + scale_msa) + shift_msa
        x = x + self.attn1(h, freqs=freqs) * gate_msa
        x = x + self.attn2(x, context=context, kv_lens=encoder_kv_lens)  # LTX quirk: no pre-norm
        h = self.norm2(x) * (1.0 + scale_mlp) + shift_mlp
        return x + self.ff(h) * gate_mlp


class _CaptionProjection(nn.Module):
    def __init__(self, in_features: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = LoRADense(in_features, dim, dtype=dtype)
        self.linear_2 = LoRADense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))


class LTXVideoTransformer3DModel(nn.Module):
    def __init__(self, in_channels: int = 128, out_channels: int = 128, patch_size: int = 1,
                 patch_size_t: int = 1, num_attention_heads: int = 32, attention_head_dim: int = 64,
                 cross_attention_dim: int = 2048, num_layers: int = 28, caption_channels: int = 4096,
                 lora_rank: int = 0, lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: Optional[str] = None) -> None:
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.inner = inner
        # Per-block remat policy for training (None or a type of CHECKPOINT_TYPES), read by block_stack.
        self.gradient_checkpointing = gradient_checkpointing
        self.dtype = dtype
        self.out_channels = out_channels
        self.patch_size = patch_size
        self.patch_size_t = patch_size_t
        self.proj_in = LoRADense(in_channels * patch_size * patch_size * patch_size_t, inner, dtype=dtype)
        self.time_embed = LTXAdaLayerNormSingle(inner, dtype=dtype)
        self.caption_projection = _CaptionProjection(caption_channels, inner, dtype)
        self.rope = LTXRotaryPosEmbed(inner, patch_size=patch_size, patch_size_t=patch_size_t)
        self.transformer_blocks = nn.ModuleList([
            LTXTransformerBlock(inner, num_attention_heads, attention_head_dim, lora_rank, lora_alpha, dtype)
            for _ in range(num_layers)
        ])
        self.scale_shift_table = nn.Parameter(torch.empty(2, inner, dtype=torch.float32))
        self.norm_out = RMSNorm(inner, elementwise_affine=False, dtype=dtype)
        self.proj_out = LoRADense(inner, out_channels * patch_size * patch_size * patch_size_t, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale_shift_table.normal_(0.0, self.inner**-0.5, generator=generator)

    def forward(
        self,
        hidden_states: torch.Tensor,  # packed tokens (B, S, in_channels*p*p*pt)
        encoder_hidden_states: torch.Tensor,  # (B, L, caption_channels)
        timestep: torch.Tensor,  # (B,) or (B, S) in [0, 1000)
        encoder_attention_mask: Optional[torch.Tensor] = None,  # (B, L) mask or (B,) kv_lens
        num_frames: int = 1,
        height: int = 1,
        width: int = 1,
        rope_interpolation_scale: Sequence[float] = (1.0, 32.0, 32.0),
    ) -> torch.Tensor:
        x = self.proj_in(hidden_states.to(self.dtype))
        temb, embedded_timestep = self.time_embed(timestep.float())
        context = self.caption_projection(encoder_hidden_states.to(self.dtype))
        kv_lens = None
        if encoder_attention_mask is not None:
            mask = encoder_attention_mask.to(torch.int32)
            kv_lens = mask.sum(dim=1, dtype=torch.int32) if mask.ndim == 2 else mask
        freqs = self.rope(num_frames, height, width, rope_interpolation_scale, x.device)
        x = block_stack(self.transformer_blocks, x, context, temb, freqs, kv_lens,
                        checkpoint=self.gradient_checkpointing)
        emb_t = embedded_timestep.reshape(embedded_timestep.shape[0], -1, self.inner).float()
        shift = (self.scale_shift_table[0][None, None] + emb_t).to(self.dtype)
        scale = (self.scale_shift_table[1][None, None] + emb_t).to(self.dtype)
        x = self.norm_out(x) * (1.0 + scale) + shift
        return self.proj_out(x).float()


def pack_latents(latents: torch.Tensor, patch_size: int = 1, patch_size_t: int = 1) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, F/pt * H/p * W/p, C*pt*p*p)."""
    b, c, f, h, w = latents.shape
    pf, ph, pw = f // patch_size_t, h // patch_size, w // patch_size
    x = latents.reshape(b, c, pf, patch_size_t, ph, patch_size, pw, patch_size)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, pf * ph * pw, c * patch_size_t * patch_size * patch_size)


def unpack_latents(packed: torch.Tensor, num_frames: int, height: int, width: int,
                   patch_size: int = 1, patch_size_t: int = 1) -> torch.Tensor:
    b, s, d = packed.shape
    pf, ph, pw = num_frames // patch_size_t, height // patch_size, width // patch_size
    c = d // (patch_size_t * patch_size * patch_size)
    x = packed.reshape(b, pf, ph, pw, c, patch_size_t, patch_size, patch_size)
    x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, c, num_frames, height, width)
