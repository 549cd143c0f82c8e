"""The dummy family (port of `finetrainers_tpu/models/dummy/base_specification.py`):
a small video DiT with a linear patch VAE and a hash text embedding, which
runs every trainer and serving path without a downloaded file.

Architecture: latents (B, C, F, H, W) -> (1, 2, 2) patches -> tokens -> N
blocks of [adaLN self-attention, cross-attention to the caption over its
`kv_lens` slots, adaLN MLP] -> unpatchify; flow matching. Its full width is
its own: dim 64 in 2 heads of 32, 2 blocks, 16 caption slots of 32; on the
card both attentions run K1 (and the backward K2 and K3) at head dim 32.
Parameter names are the JAX package's flax names with `.` for `_<i>.` block
lists and `weight` for `kernel` (`weights.py`), so its parameters load strict.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...schedulers import FlowMatchEulerScheduler
from ..autoencoders import media_to_vae_input
from ..layers import (Attention, DenseMLP, LayerNorm, LoRADense, TimestepEmbedding, block_stack, init_parameters_,
                      modulate)
from ..modeling_utils import ModelHandle, ModelSpecification


class DummyTransformerBlock(nn.Module):
    """adaLN self-attention `attn1`, cross-attention `attn2` (pre-norm, no
    modulation) and an adaLN MLP `ff` (JAX :26-63)."""

    def __init__(self, dim: int, num_heads: int, ff_mult: int = 4, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        head_dim = dim // num_heads
        kw = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype)
        self.adaln_proj = LoRADense(dim, 6 * dim, dtype=dtype)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim, dtype=dtype) for _ in range(3))
        self.attn1 = Attention(dim, num_heads, head_dim, **kw)
        self.attn2 = Attention(dim, num_heads, head_dim, **kw)
        self.ff = DenseMLP(dim, dim * ff_mult, rank=lora_rank, alpha=lora_alpha, dtype=dtype)

    def forward(self, x, context, temb, kv_lens=None):
        shift_sa, scale_sa, gate_sa, shift_mlp, scale_mlp, gate_mlp = self.adaln_proj(F.silu(temb)).chunk(6, dim=-1)
        x = x + gate_sa[:, None] * self.attn1(modulate(self.norm1(x), shift_sa, scale_sa))
        x = x + self.attn2(self.norm2(x), context=context, kv_lens=kv_lens)
        return x + gate_mlp[:, None] * self.ff(modulate(self.norm3(x), shift_mlp, scale_mlp))


class DummyTransformer(nn.Module):
    """`proj_in` over the patches, `time_embed`, `caption_proj`, the blocks,
    `norm_out` and `proj_out` (JAX :66-134). forward(hidden_states (B, C, F,
    H, W), encoder_hidden_states (B, L, caption_dim), timestep (B,) in [0,
    1000), encoder_kv_lens (B,)) -> fp32 (B, C, F, H, W)."""

    def __init__(self, in_channels: int = 4, dim: int = 64, num_heads: int = 2, num_layers: int = 2,
                 caption_dim: int = 32, patch_size: Tuple[int, int, int] = (1, 2, 2), lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: Optional[str] = None) -> None:
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.dtype = dtype
        self.gradient_checkpointing = gradient_checkpointing
        patch = in_channels * int(np.prod(self.patch_size))
        self.proj_in = LoRADense(patch, dim, dtype=dtype)
        self.time_embed = TimestepEmbedding(dim, dtype=dtype)
        self.caption_proj = LoRADense(caption_dim, dim, dtype=dtype)
        self.blocks = nn.ModuleList([DummyTransformerBlock(dim, num_heads, lora_rank=lora_rank, lora_alpha=lora_alpha,
                                                           dtype=dtype) for _ in range(num_layers)])
        self.norm_out = LayerNorm(dim, dtype=dtype)
        self.proj_out = LoRADense(dim, patch, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, f, h, w = hidden_states.shape
        pf, ph, pw = self.patch_size
        x = hidden_states.reshape(b, c, f // pf, pf, h // ph, ph, w // pw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, -1, c * pf * ph * pw)
        x = self.proj_in(x.to(self.dtype))
        temb = self.time_embed(timestep)
        context = self.caption_proj(encoder_hidden_states.to(self.dtype))
        x = block_stack(self.blocks, x, context, temb, encoder_kv_lens, checkpoint=self.gradient_checkpointing)
        x = self.proj_out(self.norm_out(x))
        x = x.reshape(b, f // pf, h // ph, w // pw, c, pf, ph, pw)
        return x.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, c, f, h, w).float()


class DummyVAE(nn.Module):
    """Linear patch VAE (JAX :137-178): space-to-depth over (1, r, r) and a
    dense layer to 2 x latent_channels moments; the decode inverts it. fp32."""

    def __init__(self, latent_channels: int = 4, spatial_compression_ratio: int = 8,
                 temporal_compression_ratio: int = 1) -> None:
        super().__init__()
        self.r = spatial_compression_ratio
        self.encoder_proj = LoRADense(3 * self.r**2, 2 * latent_channels, dtype=torch.float32)
        self.decoder_proj = LoRADense(latent_channels, 3 * self.r**2, dtype=torch.float32)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, F, H, W) -> moments (B, 2 * latent, F, H/r, W/r)."""
        b, c, f, h, w = x.shape
        r = self.r
        feats = x.float().reshape(b, c, f, h // r, r, w // r, r).permute(0, 2, 3, 5, 1, 4, 6)
        feats = feats.reshape(b, f, h // r, w // r, c * r * r)
        return self.encoder_proj(feats).permute(0, 4, 1, 2, 3).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent, F, H/r, W/r) -> (B, 3, F, H, W)."""
        b, c, f, hh, ww = z.shape
        r = self.r
        feats = self.decoder_proj(z.permute(0, 2, 3, 4, 1).float())
        x = feats.reshape(b, f, hh, ww, 3, r, r).permute(0, 4, 1, 2, 5, 3, 6)
        return x.reshape(b, 3, f, hh * r, ww * r).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode(x).chunk(2, dim=1)
        return self.decode(mean)


def sample_posterior(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussian sample of (mean, logvar) moments on dim 1, the standard
    normal `noise` given (JAX :181-187)."""
    mean, logvar = moments.chunk(2, dim=1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise.to(device=mean.device, dtype=mean.dtype)


def _hash_embedding(text: str, length: int, dim: int) -> np.ndarray:
    """Copied from JAX :190-194: a deterministic pseudo text embedding."""
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "little")
    rng = np.random.RandomState(seed)
    return rng.randn(length, dim).astype(np.float32) * 0.02


class DummyModelSpecification(ModelSpecification):
    """The dummy family (JAX :197-318): hash-embedded captions with `kv_lens`,
    VAE moments sampled in the forward, flow matching, the Euler denoise loop
    and the VAE decode for validation."""

    transformer_class_name = "DummyTransformer"
    caption_dim = 32
    caption_len = 16
    # Test hook, as in JAX: fixtures that need another dummy architecture set
    # this class attribute (monkeypatch) instead of an environment variable.
    transformer_config_overrides: Dict[str, Any] = {}

    @staticmethod
    def transformer_key_map(flax_key: str) -> str:
        from .weights import dummy_key_map

        return dummy_key_map(flax_key)

    def __init__(self, *args, lora_rank: int = 0, lora_alpha: float = 1.0,
                 transformer_config: Optional[Dict[str, Any]] = None, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.transformer_config = {
            "in_channels": 4, "dim": 64, "num_heads": 2, "num_layers": 2,
            "caption_dim": self.caption_dim, "patch_size": (1, 2, 2),
        }
        self.transformer_config.update(self.transformer_config_overrides)
        self.transformer_config.update(transformer_config or {})
        self.vae_config = {"latent_channels": 4, "spatial_compression_ratio": 8, "temporal_compression_ratio": 1}
        self._scheduler = FlowMatchEulerScheduler()

    # ------------------------------------------------------------------ loading
    def load_condition_models(self) -> Dict[str, Any]:
        return {"tokenizer": None, "text_encoder": None}  # the hash embedding needs none

    def load_latent_models(self) -> Dict[str, Any]:
        with torch.device(self.device):
            module = DummyVAE(**self.vae_config)
        init_parameters_(module, self.generator()).eval()
        return {"vae": ModelHandle(module, dict(self.vae_config))}

    def load_diffusion_models(self) -> Dict[str, Any]:
        with torch.device(self.device):
            module = DummyTransformer(**self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                                      dtype=self.transformer_dtype, gradient_checkpointing=self.gradient_checkpointing)
        init_parameters_(module, self.generator()).eval()
        return {"transformer": ModelHandle(module, dict(self.transformer_config)), "scheduler": self._scheduler}

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None, **kwargs):
        from .pipeline import DummyPipeline

        vae = vae or self.load_latent_models()["vae"]
        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        return DummyPipeline(spec=self, transformer=transformer, vae=vae, scheduler=FlowMatchEulerScheduler())

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, 16, 32), encoder_kv_lens [16]} (JAX :249-251)."""
        emb = _hash_embedding(caption, self.caption_len, self.caption_dim)[None]
        return {"encoder_hidden_states": emb, "encoder_kv_lens": np.asarray([self.caption_len], np.int32)}

    def prepare_latents(self, vae: ModelHandle, image: Optional[np.ndarray] = None,
                        video: Optional[np.ndarray] = None, compute_posterior: bool = False,
                        **kwargs) -> Dict[str, Any]:
        """An image (C, H, W) or a video (T, C, H, W) -> {"latents": the VAE's
        moments (1, 8, F, H/8, W/8), fp32 on the VAE's device} (JAX :253-270).
        The trainer samples the posterior in `forward`, so `compute_posterior`
        must stay False."""
        if compute_posterior:
            raise NotImplementedError("the port precomputes VAE moments only (compute_posterior=False)")
        device = next(vae.module.parameters()).device
        with torch.no_grad():
            return {"latents": vae.module.encode(media_to_vae_input(image, video, device))}

    # ---------------------------------------------------------------- training
    def forward(
        self,
        transformer: ModelHandle,
        condition_model_conditions: Dict[str, torch.Tensor],
        latent_model_conditions: Dict[str, torch.Tensor],
        sigmas: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, Any]] = None,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Flow-matching forward (JAX :273-300) -> (pred, target, sigmas): the
        moments sampled, x_t = (1 - sigma) x0 + sigma n, the model at timestep
        sigma * 1000, target n - x0. The draws "posterior" and "noise"
        (standard normal, the latents' shape) come from `draws` where given,
        else from `generator`."""
        draws = draws or {}
        device = sigmas.device

        def draw(name, shape):
            value = draws.get(name)
            if value is None:
                return torch.randn(shape, generator=generator, device=device)
            return torch.as_tensor(value).to(device).float().reshape(shape)

        moments = latent_model_conditions["latents"].to(device).float()
        mean_shape = (moments.shape[0], moments.shape[1] // 2, *moments.shape[2:])
        latents = sample_posterior(moments, draw("posterior", mean_shape))
        noise = draw("noise", latents.shape)
        sigmas_e = sigmas.reshape(sigmas.shape + (1,) * (latents.ndim - 1))
        noisy = flow_match_xt(latents, noise, sigmas_e)
        kv_lens = condition_model_conditions.get("encoder_kv_lens")
        pred = transformer.module(noisy, torch.as_tensor(condition_model_conditions["encoder_hidden_states"]).to(device),
                                  (sigmas * 1000.0).float(),
                                  encoder_kv_lens=None if kv_lens is None else torch.as_tensor(kv_lens).to(device))
        return pred, flow_match_target(noise, latents), sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, height: int = 32, width: int = 32, num_frames: int = 1,
                   num_inference_steps: int = 4, **kwargs) -> List[Any]:
        from ...data import VideoArtifact

        video = pipeline(prompt=prompt, height=height, width=width, num_frames=num_frames,
                         num_inference_steps=num_inference_steps)
        return [VideoArtifact(value=video)]

    def cp_plan(self) -> Dict[str, int]:
        """The dim a context-parallel split cuts: the latents' frames (JAX :309-312)."""
        return {"latents": 2}

    @property
    def _resolution_dim_keys(self) -> Dict[str, Tuple[int, ...]]:
        return {"latents": (2, 3, 4)}
