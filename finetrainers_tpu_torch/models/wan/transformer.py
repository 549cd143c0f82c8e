"""Wan 2.1 DiT in PyTorch (port of `finetrainers_tpu/models/wan/transformer.py`).

Structure: 3D patch embed (1, 2, 2) -> [N x block: adaLN(self-attention with
3D axial RoPE and per-head-shared tables, RMS QK norm over the inner dim) ->
LayerNorm cross-attention to the text (`kv_lens` from its mask), plus for
image-to-video a separate image-KV branch over the image embeds ->
adaLN(GELU-tanh MLP)] -> norm_out + table modulation -> proj_out, fp32 out.
The modulation is a per-sample (B, 6, dim) table, not per token (unlike LTX).
Module and parameter names are diffusers' `WanTransformer3DModel` names, except
the patch embedding, a linear layer over flattened patches as in the JAX
package. With `image_dim` set (I2V) every block's cross-attention carries
`add_k_proj`/`add_v_proj`/`norm_added_k`, and the image embedder maps the
CLIP-vision embeds to the model width; without image embeds in the call the
branch is skipped, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention_dispatch
from ..layers import (
    FeedForward,
    LayerNorm,
    LoRADense,
    RMSNorm,
    axial_rope_freqs,
    block_stack,
    sinusoidal_timestep_embedding,
)

def wan_rope_freqs(head_dim: int, num_frames: int, height: int, width: int,
                   device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D axial RoPE angles (transformer.py:33): h and w get a third of the
    slots each, t the rest. (S, head_dim/2) fp32 cos and sin."""
    return axial_rope_freqs(head_dim, (num_frames, height, width), (1 / 3, 1 / 3, 1 / 3), device=device)


class WanRotaryPosEmbed(nn.Module):
    """The repeat-2 expanded (S, head_dim) fp32 tables that every attention
    layer takes (transformer.py:77-81), built once per grid and device and kept."""

    def __init__(self, head_dim: int) -> None:
        super().__init__()
        self.head_dim = head_dim
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def forward(self, num_frames: int, height: int, width: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (num_frames, height, width, str(device))
        if key not in self._tables:
            cos, sin = wan_rope_freqs(self.head_dim, num_frames, height, width, device=device)
            self._tables[key] = (cos.repeat_interleave(2, dim=-1), sin.repeat_interleave(2, dim=-1))
        return self._tables[key]


class WanAttention(nn.Module):
    """Wan attention: q/k/v/out with biases, RMS norm of q and k over the
    inner dim, heads of `head_dim`. Self-attention passes the expanded tables
    to `attention_dispatch`: `auto` fuses the rotation into K1's pre-pass,
    `sage` into K6's. With `has_image_kv` (I2V cross-attention), q also
    attends to the image keys in a second call, without RoPE or `kv_lens`,
    and the two outputs add (JAX transformer.py:83-92)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, has_image_kv: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16, eps: float = 1e-6) -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        self.to_q = LoRADense(dim, inner, **kw)
        self.to_k = LoRADense(dim, inner, **kw)
        self.to_v = LoRADense(dim, inner, **kw)
        self.norm_q = RMSNorm(inner, eps=eps, dtype=dtype)
        self.norm_k = RMSNorm(inner, eps=eps, dtype=dtype)
        self.to_out = nn.ModuleList([LoRADense(inner, dim, **kw)])
        self.has_image_kv = has_image_kv
        if has_image_kv:
            self.add_k_proj = LoRADense(dim, inner, **kw)
            self.add_v_proj = LoRADense(dim, inner, **kw)
            self.norm_added_k = RMSNorm(inner, eps=eps, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                kv_lens: Optional[torch.Tensor] = None,
                image_context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, skv = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.norm_q(self.to_q(x)).reshape(b, sq, self.num_heads, self.head_dim)
        k = self.norm_k(self.to_k(ctx)).reshape(b, skv, self.num_heads, self.head_dim)
        v = self.to_v(ctx).reshape(b, skv, self.num_heads, self.head_dim)
        out = attention_dispatch(q, k, v, kv_lens=kv_lens, rope_freqs=rope)
        if self.has_image_kv and image_context is not None:
            s_img = image_context.shape[1]
            k_img = self.norm_added_k(self.add_k_proj(image_context)).reshape(b, s_img, self.num_heads, self.head_dim)
            v_img = self.add_v_proj(image_context).reshape(b, s_img, self.num_heads, self.head_dim)
            out = out + attention_dispatch(q, k_img, v_img)
        return self.to_out[0](out.reshape(b, sq, self.num_heads * self.head_dim))


class WanTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, ffn_dim: int, has_image_kv: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        kw = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, dim, dtype=torch.float32))
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn1 = WanAttention(dim, num_heads, head_dim, **kw)
        self.norm2 = LayerNorm(dim, elementwise_affine=True, use_bias=True, dtype=dtype)
        self.attn2 = WanAttention(dim, num_heads, head_dim, has_image_kv=has_image_kv, **kw)
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.ffn = FeedForward(dim, ffn_dim, rank=lora_rank, alpha=lora_alpha, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale_shift_table.normal_(0.0, self.dim**-0.5, generator=generator)

    def forward(self, x, context, temb, rope, encoder_kv_lens=None, image_context=None):
        # scale_shift_table (1, 6, dim) + temb (B, 6, dim), added in fp32, then
        # each (B, 1, dim) slice cast (transformer.py:110-113).
        ada = self.scale_shift_table + temb.float()
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = [
            ada[:, i][:, None].to(self.dtype) for i in range(6)
        ]
        h = self.norm1(x) * (1.0 + scale_msa) + shift_msa
        x = x + self.attn1(h, rope=rope) * gate_msa
        x = x + self.attn2(self.norm2(x), context=context, kv_lens=encoder_kv_lens, image_context=image_context)
        h = self.norm3(x) * (1.0 + c_scale) + c_shift
        return x + self.ffn(h) * c_gate


class _LinearPair(nn.Module):
    """linear_1 (in -> dim) and linear_2 (dim -> dim): diffusers' time and
    text embedders; the activation between them is the caller's."""

    def __init__(self, in_features: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.linear_1 = LoRADense(in_features, dim, dtype=dtype)
        self.linear_2 = LoRADense(dim, dim, dtype=dtype)


class _ImageEmbedder(nn.Module):
    """norm1 -> ff (GELU-tanh) -> norm2 over the image embeds, diffusers'
    `WanImageEmbedding` names (JAX transformer.py:194-203)."""

    def __init__(self, image_dim: int, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.norm1 = LayerNorm(image_dim, elementwise_affine=True, dtype=dtype)
        self.ff = FeedForward(image_dim, dim, out_features=dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, elementwise_affine=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.ff(self.norm1(x)))


class _ConditionEmbedder(nn.Module):
    def __init__(self, dim: int, freq_dim: int, text_dim: int, image_dim: Optional[int], dtype: torch.dtype) -> None:
        super().__init__()
        self.time_embedder = _LinearPair(freq_dim, dim, dtype)
        self.time_proj = LoRADense(dim, 6 * dim, dtype=dtype)
        self.text_embedder = _LinearPair(text_dim, dim, dtype)
        if image_dim is not None:
            self.image_embedder = _ImageEmbedder(image_dim, dim, dtype)


class WanTransformer3DModel(nn.Module):
    def __init__(self, in_channels: int = 16, out_channels: int = 16, patch_size: Tuple[int, int, int] = (1, 2, 2),
                 num_attention_heads: int = 12, attention_head_dim: int = 128, num_layers: int = 30,
                 ffn_dim: int = 8960, text_dim: int = 4096, freq_dim: int = 256, image_dim: Optional[int] = None,
                 lora_rank: int = 0, lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: Optional[str] = None) -> None:
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.inner = inner
        self.dtype = dtype
        self.out_channels = out_channels
        self.patch_size = tuple(patch_size)
        self.freq_dim = freq_dim
        self.image_dim = image_dim
        # Per-block remat policy (None or a type of CHECKPOINT_TYPES), read by block_stack.
        self.gradient_checkpointing = gradient_checkpointing
        pt, ph, pw = self.patch_size
        self.patch_embedding = LoRADense(in_channels * pt * ph * pw, inner, dtype=dtype)
        self.condition_embedder = _ConditionEmbedder(inner, freq_dim, text_dim, image_dim, dtype)
        self.rope = WanRotaryPosEmbed(attention_head_dim)
        self.blocks = nn.ModuleList([
            WanTransformerBlock(inner, num_attention_heads, attention_head_dim, ffn_dim,
                                has_image_kv=image_dim is not None, lora_rank=lora_rank, lora_alpha=lora_alpha,
                                dtype=dtype)
            for _ in range(num_layers)
        ])
        self.scale_shift_table = nn.Parameter(torch.empty(1, 2, inner, dtype=torch.float32))
        self.norm_out = LayerNorm(inner, dtype=dtype)
        self.proj_out = LoRADense(inner, out_channels * pt * ph * pw, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale_shift_table.normal_(0.0, self.inner**-0.5, generator=generator)

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, C, F, H, W)
        encoder_hidden_states: torch.Tensor,  # (B, L, text_dim)
        timestep: torch.Tensor,  # (B,)
        encoder_attention_mask: Optional[torch.Tensor] = None,  # (B, L) mask or (B,) kv_lens
        encoder_hidden_states_image: Optional[torch.Tensor] = None,  # (B, Li, image_dim), I2V
    ) -> torch.Tensor:
        b, c, f, h, w = hidden_states.shape
        pt, ph, pw = self.patch_size
        pf, phh, pww = f // pt, h // ph, w // pw

        x = hidden_states.reshape(b, c, pf, pt, phh, ph, pww, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = self.patch_embedding(x.reshape(b, pf * phh * pww, c * pt * ph * pw).to(self.dtype))

        cond = self.condition_embedder
        temb_sin = sinusoidal_timestep_embedding(timestep.float(), self.freq_dim)
        temb = cond.time_embedder.linear_2(F.silu(cond.time_embedder.linear_1(temb_sin.to(self.dtype))))
        temb_proj = cond.time_proj(F.silu(temb)).reshape(b, 6, self.inner)
        context = cond.text_embedder.linear_2(
            F.gelu(cond.text_embedder.linear_1(encoder_hidden_states.to(self.dtype)), approximate="tanh"))
        image_context = None
        if self.image_dim is not None and encoder_hidden_states_image is not None:
            image_context = cond.image_embedder(encoder_hidden_states_image.to(self.dtype))

        kv_lens = None
        if encoder_attention_mask is not None:
            mask = encoder_attention_mask.to(torch.int32)
            kv_lens = mask.sum(dim=1, dtype=torch.int32) if mask.ndim == 2 else mask

        rope = self.rope(pf, phh, pww, x.device)
        x = block_stack(self.blocks, x, context, temb_proj, rope, kv_lens, image_context,
                        checkpoint=self.gradient_checkpointing)

        mod = self.scale_shift_table + temb[:, None].float()  # (B, 2, inner)
        shift, scale = mod[:, 0][:, None].to(self.dtype), mod[:, 1][:, None].to(self.dtype)
        x = self.norm_out(x) * (1.0 + scale) + shift
        x = self.proj_out(x)

        x = x.reshape(b, pf, phh, pww, self.out_channels, pt, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return x.reshape(b, self.out_channels, f, h, w).float()
