"""Shared building blocks (port of the parts of `finetrainers_tpu/models/layers.py`
that the port's families run).

Parameter names follow diffusers/peft: a linear layer holds `weight` (out, in)
and `bias`; its LoRA factors are `lora_A.weight` (r, in) and `lora_B.weight`
(out, r), so a peft state dict loads strict. Base weights are stored in the
module's compute dtype (the JAX package keeps fp32 params and casts them at
every call, which is the same arithmetic); LoRA factors and norm scales stay
fp32 and are cast where the JAX package casts them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.activation_checkpoint import apply_activation_checkpointing, should_checkpoint_block


class LoRAFactor(nn.Module):
    """One LoRA factor, kept fp32 (peft's `lora_A` / `lora_B` submodules)."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=torch.float32))


class LoRADense(nn.Module):
    """y = x W^T + b + (alpha/r) (x A^T) B^T  (`LoRADense`, layers.py:34).

    rank=0 disables LoRA. The LoRA branch runs two skinny matmuls in the
    compute dtype, with the fp32 factors cast to it (layers.py:75-81). The
    compute dtype is `dtype`; a layer whose weight and bias are later kept in
    fp32 (the control trainer's full-rank injection layer, as JAX keeps every
    parameter) casts them to it at each call, as JAX does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, rank: int = 0,
                 alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.rank = rank
        self.scaling = alpha / rank if rank > 0 else 0.0
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=dtype)) if bias else None
        if rank > 0:
            self.lora_A = LoRAFactor(in_features, rank)
            self.lora_B = LoRAFactor(rank, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init: weights ~ N(0, 1/in) (the scale of flax's lecun_normal),
        zero bias, lora_A ~ N(0, 1/r) and lora_B = 0 as in the JAX package."""
        with torch.no_grad():
            self.weight.normal_(0.0, self.in_features**-0.5, generator=generator)
            if self.bias is not None:
                self.bias.zero_()
            if self.rank > 0:
                self.lora_A.weight.normal_(0.0, 1.0 / self.rank, generator=generator)
                self.lora_B.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.to(self.compute_dtype)
        bias = None if self.bias is None else self.bias.to(xc.dtype)
        if self.weight.dtype == torch.int8:
            # A frozen weight stored int8 (`utils.int8.apply_int8_storage`, scales in `weight_qscale`): the
            # forward and input-gradient products run on int8 GEMMs (layers.py:54-63).
            from ..ops.int8_linear import int8_linear

            y = int8_linear(xc, self.weight, self.weight_qscale)
            if bias is not None:
                y = y + bias
        else:  # fp8 storage (`utils.fp8`) is cast to the compute dtype here, as any other dtype
            y = F.linear(xc, self.weight.to(xc.dtype), bias)
        if self.rank > 0:
            delta = F.linear(F.linear(xc, self.lora_A.weight.to(xc.dtype)), self.lora_B.weight.to(xc.dtype))
            y = y + (self.scaling * delta).to(y.dtype)
        return y


def dense_weight(layer: "LoRADense") -> torch.Tensor:
    """A layer's weight as a fused consumer reads it: an int8-stored weight
    dequantized with its scales to the compute dtype (the fused matmul takes the
    storage's memory saving, not the int8 products: layers.py:102-107), an fp8
    one cast to it, any other as it is stored."""
    if layer.weight.dtype == torch.int8:
        return (layer.weight.float() * layer.weight_qscale[:, None]).to(layer.compute_dtype)
    if layer.weight.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return layer.weight.to(layer.compute_dtype)
    return layer.weight


def lora_proj_params(layers):
    """Fused projection (`LoRAProjParams`, layers.py:85): concatenate several
    LoRADense layers that read the same input into one (sum out, in) weight,
    one bias, and one stacked lora_A, so a parent runs one wide matmul (and one
    LoRA-A matmul) instead of several narrow ones. Returns (weight, bias,
    lora_A or None, [lora_B, ...] or None)."""
    weight = torch.cat([dense_weight(layer) for layer in layers], dim=0)
    bias = torch.cat([layer.bias for layer in layers]) if layers[0].bias is not None else None
    if layers[0].rank == 0:
        return weight, bias, None, None
    lora_a = torch.cat([layer.lora_A.weight for layer in layers], dim=0)
    return weight, bias, lora_a, [layer.lora_B.weight for layer in layers]


class _GELUProjection(nn.Module):
    def __init__(self, dim: int, inner: int, **kw) -> None:
        super().__init__()
        self.proj = LoRADense(dim, inner, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """diffusers FeedForward layout: net.0.proj -> gelu(tanh) -> net.2 (the
    `ff_net_0_proj` / `ff_net_2` (LTX) and `ffn_net_*` (Wan) dense pairs of
    the JAX blocks), `dim` -> `inner` -> `out_features` (default `dim`). `kw`
    goes to both LoRADense layers."""

    def __init__(self, dim: int, inner: int, out_features: Optional[int] = None, **kw) -> None:
        super().__init__()
        self.net = nn.ModuleList([_GELUProjection(dim, inner, **kw), nn.Identity(),
                                  LoRADense(inner, out_features or dim, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class DenseMLP(nn.Module):
    """The JAX package's `FeedForward` layout (layers.py:295): `proj_in` ->
    gelu(tanh) -> `proj_out`, `dim` -> `inner` -> `dim`; `kw` goes to both
    LoRADense layers (the families that load diffusers' `net.0.proj` names
    use `FeedForward` instead)."""

    def __init__(self, dim: int, inner: int, **kw) -> None:
        super().__init__()
        self.proj_in = LoRADense(dim, inner, **kw)
        self.proj_out = LoRADense(inner, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(x), approximate="tanh"))


class Attention(nn.Module):
    """Multi-head self- or cross-attention with biases and LoRA on
    to_q/to_k/to_v/to_out (`Attention`, layers.py:229, without its optional
    qk-norm and RoPE): (B, S, dim) in, heads split to (B, S, N, H) for
    `attention_dispatch`, with `kv_lens` for the context's valid keys."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: Optional[int] = None,
                 lora_rank: int = 0, lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        kw = dict(rank=lora_rank, alpha=lora_alpha, dtype=dtype)
        self.to_q = LoRADense(dim, inner, **kw)
        self.to_k = LoRADense(context_dim or dim, inner, **kw)
        self.to_v = LoRADense(context_dim or dim, inner, **kw)
        self.to_out = LoRADense(inner, dim, **kw)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..ops import attention_dispatch

        ctx = x if context is None else context
        b, sq, skv = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).reshape(b, sq, self.num_heads, self.head_dim)
        k = self.to_k(ctx).reshape(b, skv, self.num_heads, self.head_dim)
        v = self.to_v(ctx).reshape(b, skv, self.num_heads, self.head_dim)
        out = attention_dispatch(q, k, v, kv_lens=kv_lens)
        return self.to_out(out.reshape(b, sq, self.num_heads * self.head_dim))


class RMSNorm(nn.Module):
    """RMSNorm with fp32 statistics and an optional fp32 scale (layers.py:121)."""

    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine: bool = True,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32)) if elementwise_affine else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        if self.weight is not None:
            y = y * self.weight
        return y.to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and a two-pass variance (layers.py:143);
    without affine parameters by default (DiT blocks follow it with adaLN
    modulation), else an fp32 scale and optional fp32 bias."""

    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine: bool = False, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32)) if elementwise_affine else None
        self.bias = nn.Parameter(torch.empty(dim, dtype=torch.float32)) if elementwise_affine and use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        centred = x32 - x32.mean(dim=-1, keepdim=True)
        y = centred * torch.rsqrt(centred.square().mean(dim=-1, keepdim=True) + self.eps)
        if self.weight is not None:
            y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0, flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0, scale: float = 1.0,
) -> torch.Tensor:
    """Standard DDPM sinusoidal embedding in fp32 (layers.py:168)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Sinusoidal embedding (flip_sin_to_cos, no shift) -> `linear_1` -> silu
    -> `linear_2` (`TimestepEmbedding`, layers.py:185)."""

    def __init__(self, dim: int, freq_dim: int = 256, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.freq_dim, self.dtype = freq_dim, dtype
        self.linear_1 = LoRADense(freq_dim, dim, dtype=dtype)
        self.linear_2 = LoRADense(dim, dim, dtype=dtype)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_timestep_embedding(timesteps, self.freq_dim, flip_sin_to_cos=True, downscale_freq_shift=0.0)
        return self.linear_2(F.silu(self.linear_1(emb.to(self.dtype))))


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation (layers.py:328): shift and scale (B, D) over the sequence."""
    return x * (1.0 + scale[:, None]) + shift[:, None]


ROPE_THETA = 10000.0


def axial_rope_freqs(head_dim: int, sizes: Sequence[int], fractions: Sequence[float],
                     device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """N-axis RoPE angles with exact frequency-slot allocation (layers.py:596):
    the head_dim/2 slots go to the axes in proportion to `fractions`, the last
    axis taking the remainder; tokens are row-major over `sizes`. Returns fp32
    (cos, sin) of shape (prod(sizes), head_dim/2), computed in fp32 as the JAX
    package does, so the tables match its own."""
    total_slots = head_dim // 2
    slots = [max(int(total_slots * frac), 1) for frac in fractions[:-1]]
    slots.append(total_slots - sum(slots))
    grids = torch.meshgrid(*[torch.arange(size, dtype=torch.float32, device=device) for size in sizes],
                           indexing="ij")
    parts = []
    for pos, n_slots in zip(grids, slots):
        inv = 1.0 / torch.pow(ROPE_THETA, torch.arange(n_slots, dtype=torch.float32, device=device) / max(n_slots, 1))
        parts.append(pos.reshape(-1, 1) * inv[None, :])
    freqs = torch.cat(parts, dim=-1)
    return torch.cos(freqs), torch.sin(freqs)


def block_stack(blocks: nn.ModuleList, carry, *broadcast_args, checkpoint: Optional[str] = None):
    """Run identical blocks in order (`block_stack`, layers.py:354): a plain
    loop. checkpoint: None or a type of `CHECKPOINT_TYPES` wraps each block
    (every second block for "block_skip") in a non-reentrant
    `torch.utils.checkpoint` with that type's policy, as the JAX `block_stack`
    remats each block with `get_checkpoint_policy` (:419, :452, :577): "full"
    recomputes the block in the backward, "ops"/"ops_attn"/"ops_narrow" save
    what their policy names. It has no effect where autograd records nothing."""
    for i, block in enumerate(blocks):
        if checkpoint is not None and torch.is_grad_enabled() and should_checkpoint_block(i, checkpoint):
            carry = apply_activation_checkpointing(block, checkpoint)(carry, *broadcast_args)
        else:
            carry = block(carry, *broadcast_args)
    return carry


def init_parameters_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Random-init a model in place from `generator`. Every port module that
    owns parameters defines `reset_parameters(generator)` for its own ones."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
