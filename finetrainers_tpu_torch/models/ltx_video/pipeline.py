"""LTX-Video text-to-video pipeline, flow-match Euler (port of
`finetrainers_tpu/models/ltx_video/pipeline.py`). Image-to-video is not
ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ...schedulers import FlowMatchEulerScheduler
from ..modeling_utils import ModelHandle
from .transformer import pack_latents, unpack_latents


@dataclasses.dataclass
class LTXPipeline:
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
                     sigma: float, rope_scale: Sequence[float]) -> torch.Tensor:
        """One transformer evaluation (CFG batch 2 when `ehs` holds two rows):
        returns the guided velocity in the latents' (1, C, F', H', W') layout."""
        cfg = self.spec.transformer_config
        p, pt = cfg["patch_size"], cfg["patch_size_t"]
        _, _, latent_f, latent_h, latent_w = latents.shape
        do_cfg = ehs.shape[0] == 2
        packed = pack_latents(latents, p, pt)
        model_in = torch.cat([packed] * 2) if do_cfg else packed
        # sigma * 1000 is formed in fp32, as the JAX step does.
        t = float(np.float32(sigma) * np.float32(1000.0))
        timesteps = torch.full(model_in.shape[:2], t, dtype=torch.float32, device=latents.device)
        pred = self.transformer.module(
            model_in, ehs, timesteps, encoder_attention_mask=mask,
            num_frames=latent_f, height=latent_h, width=latent_w, rope_interpolation_scale=rope_scale,
        )
        if do_cfg:
            uncond, cond = pred.chunk(2)
            pred = uncond + guidance_scale * (cond - uncond)
        return unpack_latents(pred, latent_f, latent_h, latent_w, p, pt)

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        negative_prompt: Optional[str] = None,
        image: Optional[np.ndarray] = None,
        height: int = 512,
        width: int = 704,
        num_frames: int = 49,
        frame_rate: int = 25,
        num_inference_steps: int = 50,
        guidance_scale: float = 3.0,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> np.ndarray:
        """Generate one video -> uint8 (F, H, W, 3). `latents` is an optional
        explicit initial draw of `latent_shape(...)`; without it the draw comes
        from `torch.Generator(device).manual_seed(seed)`."""
        if image is not None:
            raise NotImplementedError("image-to-video is not ported yet; see ROADMAP.md")
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
        sr = self.vae.config["spatial_compression_ratio"]
        latent_frame_rate = frame_rate / self.vae.config["temporal_compression_ratio"]
        rope_scale = (1.0 / latent_frame_rate, float(sr), float(sr))
        sampler = self.scheduler.make_sampler(sigmas)
        for i in range(num_inference_steps):
            pred = self.denoise_step(latents, ehs, mask, guidance_scale, float(sigmas[i]), rope_scale)
            latents = sampler.update(pred, i, latents)

        mean = torch.as_tensor(self.vae.config["latents_mean"], device=device).reshape(1, -1, 1, 1, 1)
        std = torch.as_tensor(self.vae.config["latents_std"], device=device).reshape(1, -1, 1, 1, 1)
        video = self.vae.module.decode(latents * std + mean)
        if not torch.isfinite(video).all():
            raise FloatingPointError("the decoded video holds non-finite values")
        video = torch.clamp((video + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (video[0].transpose(1, 2, 3, 0) * 255).astype(np.uint8)  # (F, H, W, 3)
