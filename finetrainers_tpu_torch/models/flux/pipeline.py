"""Flux text-to-image pipeline (port of `finetrainers_tpu/models/flux/pipeline.py`):
batch 1, no CFG, the guidance scale embedded, flow-match Euler over a sigma
grid shifted by the image's token count (`_flux_shift_mu`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...schedulers import FlowMatchEulerScheduler
from ..autoencoders import decode_image_vae
from ..modeling_utils import ModelHandle
from .base_specification import SCALING_FACTOR, SHIFT_FACTOR
from .transformer import pack_flux_latents, prepare_latent_image_ids, unpack_flux_latents


def _flux_shift_mu(seq_len: int, base_len: int = 256, max_len: int = 4096,
                   base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """Copied from `finetrainers_tpu/models/flux/pipeline.py:93-97`."""
    m = (max_shift - base_shift) / (max_len - base_len)
    b = base_shift - m * base_len
    return m * seq_len + b


@dataclasses.dataclass
class FluxPipeline:
    spec: Any
    transformer: ModelHandle
    vae: ModelHandle
    text_encoder: Any
    scheduler: FlowMatchEulerScheduler

    def latent_shape(self, height: int, width: int):
        """(1, C, H', W') of the latents for an image of the given size."""
        sr = self.vae.config["spatial_compression_ratio"]
        return (1, self.vae.config["latent_channels"], height // sr, width // sr)

    def encode_prompt(self, prompt: str):
        """(encoder_hidden_states, pooled_projections) on the device; both text
        slots take the pipeline's one encoder (JAX :43)."""
        conds = self.spec.prepare_conditions(caption=prompt, text_encoder=self.text_encoder)
        device = self.spec.device
        return (torch.from_numpy(conds["encoder_hidden_states"]).to(device),
                torch.from_numpy(conds["pooled_projections"]).to(device))

    def denoise_step(self, latents: torch.Tensor, ehs: torch.Tensor, pooled: torch.Tensor, img_ids: torch.Tensor,
                     txt_ids: torch.Tensor, guidance_scale: float, sigma: float) -> torch.Tensor:
        """One transformer evaluation: the velocity in the latents' (1, C, H', W') layout."""
        h, w = latents.shape[2:]
        device = latents.device
        # sigma * 1000 and the guidance are formed in fp32, as the jitted JAX step does.
        timestep = torch.full((1,), float(np.float32(sigma) * np.float32(1000.0)), device=device)
        guidance = None
        if self.spec.transformer_config["guidance_embeds"]:
            guidance = torch.full((1,), float(np.float32(guidance_scale) * np.float32(1000.0)), device=device)
        pred = self.transformer.module(pack_flux_latents(latents).to(self.spec.transformer_dtype), ehs, pooled,
                                       timestep, img_ids, txt_ids, guidance=guidance)
        return unpack_flux_latents(pred, h, w)

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 28,
        guidance_scale: float = 3.5,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> np.ndarray:
        """Generate one image -> uint8 (H, W, 3). `latents` is an optional
        explicit initial draw of `latent_shape(...)`; without it the draw comes
        from `torch.Generator(device).manual_seed(seed)`."""
        device = self.spec.device
        shape = self.latent_shape(height, width)
        ehs, pooled = self.encode_prompt(prompt)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32, device=device)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents must have shape {shape}, got {tuple(latents.shape)}")
        img_ids = prepare_latent_image_ids(shape[2], shape[3], device)
        txt_ids = torch.zeros((ehs.shape[1], 3), device=device)

        sigmas = self.scheduler.inference_sigmas(num_inference_steps,
                                                 mu=_flux_shift_mu((shape[2] // 2) * (shape[3] // 2)))
        sampler = self.scheduler.make_sampler(sigmas)
        for i in range(num_inference_steps):
            pred = self.denoise_step(latents, ehs, pooled, img_ids, txt_ids, guidance_scale, float(sigmas[i]))
            latents = sampler.update(pred, i, latents)

        image = decode_image_vae(self.vae, latents / SCALING_FACTOR + SHIFT_FACTOR)
        if not torch.isfinite(image).all():
            raise FloatingPointError("the decoded image holds non-finite values")
        image = torch.clamp((image + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (image[0].transpose(1, 2, 0) * 255).astype(np.uint8)  # (H, W, 3)
