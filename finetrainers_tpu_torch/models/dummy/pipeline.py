"""The dummy pipeline (port of `finetrainers_tpu/models/dummy/pipeline.py`):
the Euler flow-matching denoise loop over the hash-embedded caption, then
the VAE decode to (F, H, W, 3) uint8."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...schedulers import FlowMatchEulerScheduler
from ..modeling_utils import ModelHandle


@dataclasses.dataclass
class DummyPipeline:
    spec: Any
    transformer: ModelHandle
    vae: ModelHandle
    scheduler: FlowMatchEulerScheduler

    def latent_shape(self, num_frames: int, height: int, width: int):
        r = self.vae.config.get("spatial_compression_ratio", 8)
        return (1, self.vae.config.get("latent_channels", 4), num_frames, height // r, width // r)

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        height: int = 32,
        width: int = 32,
        num_frames: int = 1,
        num_inference_steps: int = 4,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> np.ndarray:
        """Generate one video -> uint8 (F, H, W, 3) (JAX :27-65). `latents` is an
        optional explicit initial draw of `latent_shape(...)`; without it the draw
        comes from `torch.Generator(device).manual_seed(seed)`."""
        device = self.spec.device
        shape = self.latent_shape(num_frames, height, width)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32, device=device)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents must have shape {shape}, got {tuple(latents.shape)}")
        conds = self.spec.prepare_conditions(caption=prompt)
        ehs = torch.from_numpy(conds["encoder_hidden_states"]).to(device)
        kv_lens = torch.from_numpy(conds["encoder_kv_lens"]).to(device)
        sigmas = self.scheduler.inference_sigmas(num_inference_steps)
        sampler = self.scheduler.make_sampler(sigmas)
        for i in range(num_inference_steps):
            timestep = torch.full((1,), float(sigmas[i]) * 1000.0, dtype=torch.float32, device=device)
            pred = self.transformer.module(latents, ehs, timestep, encoder_kv_lens=kv_lens)
            latents = sampler.update(pred, i, latents)
        video = self.vae.module.decode(latents)
        if not torch.isfinite(video).all():
            raise FloatingPointError("the decoded video holds non-finite values")
        video = torch.clamp((video + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (video[0].transpose(1, 2, 3, 0) * 255).astype(np.uint8)  # (F, H, W, 3)
