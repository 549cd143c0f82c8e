"""CogVideoX text-to-video pipeline (port of `finetrainers_tpu/models/cogvideox/pipeline.py`):
classifier-free guidance as one batch of 2 [negative prompt ("" by
default), prompt], DDIM over the timesteps `linspace(999, 0, steps).round()`
with the model's velocity turned into x0 and eps and alpha_bar_prev = 1 on the
last step (:60-78), the latents divided by the VAE's scaling factor and
turned frames-first -> channels-first for the decode to (F, H, W, 3) uint8."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...schedulers import CogVideoXDDIMScheduler
from ..modeling_utils import ModelHandle


@dataclasses.dataclass
class CogVideoXPipeline:
    spec: Any
    transformer: ModelHandle
    vae: ModelHandle
    text_encoder: Any
    scheduler: CogVideoXDDIMScheduler

    def latent_shape(self, num_frames: int, height: int, width: int):
        """(1, F', C, H', W') of the frames-first latents for a video of the given size."""
        sr = self.vae.config["spatial_compression_ratio"]
        tr = self.vae.config["temporal_compression_ratio"]
        return (1, (num_frames - 1) // tr + 1, self.vae.config["latent_channels"], height // sr, width // sr)

    def encode_prompt(self, prompt: str, negative_prompt: Optional[str], do_cfg: bool) -> torch.Tensor:
        """The T5 states on the device; with CFG the batch is [negative, prompt]."""
        spec = self.spec
        ehs = spec.prepare_conditions(caption=prompt, text_encoder=self.text_encoder)["encoder_hidden_states"]
        if do_cfg:
            neg = spec.prepare_conditions(caption=negative_prompt or "", text_encoder=self.text_encoder)
            ehs = np.concatenate([neg["encoder_hidden_states"], ehs])
        return torch.from_numpy(ehs).to(spec.device)

    def denoise_step(self, latents: torch.Tensor, ehs: torch.Tensor, guidance_scale: float, t: int,
                     a_t: float, a_prev: float) -> torch.Tensor:
        """One DDIM step from timestep `t` (alpha_bar `a_t`) to `a_prev`: the
        guided velocity v, x0 = sqrt(a) x - sqrt(1-a) v, eps = sqrt(a) v +
        sqrt(1-a) x, then sqrt(a_prev) x0 + sqrt(1-a_prev) eps, each
        coefficient formed in fp32 as the jitted JAX step forms it."""
        do_cfg = ehs.shape[0] == 2
        model_in = torch.cat([latents] * 2) if do_cfg else latents
        timestep = torch.full((model_in.shape[0],), float(t), dtype=torch.float32, device=latents.device)
        v = self.transformer.module(model_in.to(self.spec.transformer_dtype), ehs, timestep)
        if do_cfg:
            uncond, cond = v.chunk(2)
            v = uncond + float(np.float32(guidance_scale)) * (cond - uncond)
        a_t, a_prev = np.float32(a_t), np.float32(a_prev)
        sa, s1a = float(np.sqrt(a_t)), float(np.sqrt(np.float32(1.0) - a_t))
        x0 = sa * latents - s1a * v
        eps = sa * v + s1a * latents
        return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(np.float32(1.0) - a_prev)) * eps

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 720,
        num_frames: int = 49,
        num_inference_steps: int = 50,
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
        do_cfg = guidance_scale > 1.0
        ehs = self.encode_prompt(prompt, negative_prompt, do_cfg)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32, device=device)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents must have shape {shape}, got {tuple(latents.shape)}")

        n = self.scheduler.num_train_timesteps
        timesteps = np.linspace(n - 1, 0, num_inference_steps).round().astype(np.int64)
        alphas = self.scheduler.alphas_cumprod.numpy()
        for i, t in enumerate(timesteps):
            a_prev = alphas[timesteps[i + 1]] if i + 1 < len(timesteps) else 1.0
            latents = self.denoise_step(latents, ehs, guidance_scale, int(t), alphas[t], a_prev)

        latents = latents / self.spec.vae_scaling_factor
        video = self.vae.module.decode(latents.transpose(1, 2))  # frames-first -> (1, C, F', H', W')
        if not torch.isfinite(video).all():
            raise FloatingPointError("the decoded video holds non-finite values")
        video = torch.clamp((video + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (video[0].transpose(1, 2, 3, 0) * 255).astype(np.uint8)  # (F, H, W, 3)
