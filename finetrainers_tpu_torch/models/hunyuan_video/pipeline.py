"""HunyuanVideo text-to-video pipeline (port of
`finetrainers_tpu/models/hunyuan_video/pipeline.py`): batch 1, no CFG (the
model is guidance-distilled: `guidance_scale` x 1000 is embedded), flow-match
Euler with the scheduler the spec loads (shift 7 by default), the VAE decode
to (F, H, W, 3) uint8 frames."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...schedulers import FlowMatchEulerScheduler
from ..modeling_utils import ModelHandle


@dataclasses.dataclass
class HunyuanVideoPipeline:
    spec: Any
    transformer: ModelHandle
    vae: ModelHandle
    text_encoder: Any
    scheduler: FlowMatchEulerScheduler

    def latent_shape(self, num_frames: int, height: int, width: int):
        """(1, C, F', H', W') of the latents for a video of the given size."""
        sr = self.vae.config["spatial_compression_ratio"]
        tr = self.vae.config["temporal_compression_ratio"]
        return (1, self.vae.config["latent_channels"], (num_frames - 1) // tr + 1, height // sr, width // sr)

    def encode_prompt(self, prompt: str):
        """(encoder_hidden_states, mask, pooled_projections) on the device; both
        text slots take the pipeline's one encoder (JAX :43)."""
        conds = self.spec.prepare_conditions(caption=prompt, text_encoder=self.text_encoder)
        device = self.spec.device
        return tuple(torch.from_numpy(conds[key]).to(device)
                     for key in ("encoder_hidden_states", "encoder_attention_mask", "pooled_projections"))

    def denoise_step(self, latents: torch.Tensor, ehs: torch.Tensor, mask: torch.Tensor, pooled: torch.Tensor,
                     guidance_scale: float, sigma: float) -> torch.Tensor:
        """One transformer evaluation: the velocity in the latents' (1, C, F', H', W') layout."""
        device = latents.device
        # sigma * 1000 and the guidance are formed in fp32, as the jitted JAX step does.
        timestep = torch.full((1,), float(np.float32(sigma) * np.float32(1000.0)), device=device)
        guidance = torch.full((1,), float(np.float32(guidance_scale) * np.float32(1000.0)), device=device)
        return self.transformer.module(latents.to(self.spec.transformer_dtype), ehs, timestep, pooled,
                                       encoder_attention_mask=mask, guidance=guidance)

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        height: int = 512,
        width: int = 512,
        num_frames: int = 61,
        num_inference_steps: int = 30,
        guidance_scale: float = 6.0,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> np.ndarray:
        """Generate one video -> uint8 (F, H, W, 3). `latents` is an optional
        explicit initial draw of `latent_shape(...)`; without it the draw comes
        from `torch.Generator(device).manual_seed(seed)`."""
        device = self.spec.device
        shape = self.latent_shape(num_frames, height, width)
        ehs, mask, pooled = self.encode_prompt(prompt)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32, device=device)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents must have shape {shape}, got {tuple(latents.shape)}")

        sigmas = self.scheduler.inference_sigmas(num_inference_steps)
        sampler = self.scheduler.make_sampler(sigmas)
        for i in range(num_inference_steps):
            pred = self.denoise_step(latents, ehs, mask, pooled, guidance_scale, float(sigmas[i]))
            latents = sampler.update(pred, i, latents)

        scaling = torch.tensor(self.vae.config.get("scaling_factor", 1.0), dtype=torch.float32, device=device)
        video = self.vae.module.decode(latents / scaling)
        if not torch.isfinite(video).all():
            raise FloatingPointError("the decoded video holds non-finite values")
        video = torch.clamp((video + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (video[0].transpose(1, 2, 3, 0) * 255).astype(np.uint8)  # (F, H, W, 3)
