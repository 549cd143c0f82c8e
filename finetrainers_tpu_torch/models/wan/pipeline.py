"""Wan 2.1 text-to-video pipeline, flow-match Euler (port of the T2V path of
`finetrainers_tpu/models/wan/pipeline.py`). Image-to-video and control
conditioning are not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...schedulers import FlowMatchEulerScheduler
from ..modeling_utils import ModelHandle


@dataclasses.dataclass
class WanPipeline:
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

    def encode_prompt(self, prompt: str, negative_prompt: Optional[str], do_cfg: bool):
        """Text path -> (encoder_hidden_states, mask) on the device; with CFG the
        batch is [uncond, cond]."""
        spec = self.spec
        conds = spec.prepare_conditions(caption=prompt, text_encoder=self.text_encoder)
        ehs, mask = conds["encoder_hidden_states"], conds["encoder_attention_mask"]
        if do_cfg:
            neg = spec.prepare_conditions(caption=negative_prompt or "", text_encoder=self.text_encoder)
            ehs = np.concatenate([neg["encoder_hidden_states"], ehs])
            mask = np.concatenate([neg["encoder_attention_mask"], mask])
        return torch.from_numpy(ehs).to(spec.device), torch.from_numpy(mask).to(spec.device)

    def denoise_step(self, latents: torch.Tensor, ehs: torch.Tensor, mask: torch.Tensor, guidance_scale: float,
                     sigma: float) -> torch.Tensor:
        """One transformer evaluation (CFG as one batch of 2 when `ehs` holds two
        rows): the guided velocity in the latents' (1, C, F', H', W') layout."""
        do_cfg = ehs.shape[0] == 2
        model_in = torch.cat([latents] * 2) if do_cfg else latents
        # sigma * 1000 and the guidance are formed in fp32, as the jitted JAX step does.
        t = float(np.float32(sigma) * np.float32(1000.0))
        timestep = torch.full((model_in.shape[0],), t, dtype=torch.float32, device=latents.device)
        pred = self.transformer.module(model_in.to(self.spec.transformer_dtype), ehs, timestep,
                                       encoder_attention_mask=mask)
        if do_cfg:
            uncond, cond = pred.chunk(2)
            pred = uncond + float(np.float32(guidance_scale)) * (cond - uncond)
        return pred

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        negative_prompt: Optional[str] = None,
        image: Optional[np.ndarray] = None,
        control_image: Optional[np.ndarray] = None,
        control_video: Optional[np.ndarray] = None,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> np.ndarray:
        """Generate one video -> uint8 (F, H, W, 3). `latents` is an optional
        explicit initial draw of `latent_shape(...)`; without it the draw comes
        from `torch.Generator(device).manual_seed(seed)`."""
        if image is not None or self.spec.is_i2v:
            raise NotImplementedError("Wan image-to-video is not ported yet; see ROADMAP.md queue 1 (Wan I2V)")
        if control_image is not None or control_video is not None:
            raise NotImplementedError("Wan control conditioning is not ported yet; see ROADMAP.md queue 1 (control trainer)")
        device = self.spec.device
        shape = self.latent_shape(num_frames, height, width)
        ehs, mask = self.encode_prompt(prompt, negative_prompt, guidance_scale > 1.0)
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
            pred = self.denoise_step(latents, ehs, mask, guidance_scale, float(sigmas[i]))
            latents = sampler.update(pred, i, latents)

        mean = torch.as_tensor(self.vae.config["latents_mean"], device=device).reshape(1, -1, 1, 1, 1)
        std = torch.as_tensor(self.vae.config["latents_std"], device=device).reshape(1, -1, 1, 1, 1)
        video = self.vae.module.decode(latents * std + mean)
        if not torch.isfinite(video).all():
            raise FloatingPointError("the decoded video holds non-finite values")
        video = torch.clamp((video + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (video[0].transpose(1, 2, 3, 0) * 255).astype(np.uint8)  # (F, H, W, 3)
