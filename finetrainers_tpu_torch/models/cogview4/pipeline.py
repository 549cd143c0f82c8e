"""CogView4 text-to-image pipeline (port of `finetrainers_tpu/models/cogview4/pipeline.py`):
classifier-free guidance as one batch of 2 [empty negative prompt, prompt]
with the sizes and crops doubled (:57-72), flow-match Euler with the
scheduler the spec loads, the VAE decode to (H, W, 3) uint8.

Control conditioning (:45-55): a `control_image` (uint8 (H, W, 3) or float
(3, H, W) in [-1, 1]) is resized and cropped to the request's size, encoded
by the VAE as one frame through `encode_media` (honouring the VAE's slicing
and tiling, as in training), and its posterior mean is joined to the latents
on the channel axis in every denoise step. Only a model whose patch embed
was widened for it (the control trainer's) takes the extra channels."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...schedulers import FlowMatchEulerScheduler
from ..autoencoders import decode_image_vae, encode_media
from ..modeling_utils import ModelHandle


@dataclasses.dataclass
class CogView4Pipeline:
    spec: Any
    transformer: ModelHandle
    vae: ModelHandle
    text_encoder: Any
    scheduler: FlowMatchEulerScheduler

    def latent_shape(self, height: int, width: int):
        """(1, C, H', W') of the latents for an image of the given size."""
        sr = self.vae.config["spatial_compression_ratio"]
        return (1, self.vae.config["latent_channels"], height // sr, width // sr)

    def encode_prompt(self, prompt: str, negative_prompt: Optional[str], do_cfg: bool) -> torch.Tensor:
        """The text states on the device; with CFG the batch is [negative, prompt]."""
        spec = self.spec
        ehs = spec.prepare_conditions(caption=prompt, text_encoder=self.text_encoder)["encoder_hidden_states"]
        if do_cfg:
            neg = spec.prepare_conditions(caption=negative_prompt or "", text_encoder=self.text_encoder)
            ehs = np.concatenate([neg["encoder_hidden_states"], ehs])
        return torch.from_numpy(ehs).to(spec.device)

    def control_latents(self, control_image, height: int, width: int) -> torch.Tensor:
        """The control image's posterior mean (1, C, H', W') fp32 (JAX :45-55)."""
        from ...functional.image import resize_crop_image

        img = np.asarray(control_image)
        if img.dtype == np.uint8:
            img = np.moveaxis(img.astype(np.float32) / 127.5 - 1.0, -1, 0)
        img = resize_crop_image(np.asarray(img, np.float32), (height, width))
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.spec.device)[None, :, None]
        return encode_media(self.vae, x)[:, :, 0].chunk(2, dim=1)[0].float()

    def denoise_step(self, latents: torch.Tensor, ehs: torch.Tensor, sizes: torch.Tensor, crops: torch.Tensor,
                     guidance_scale: float, sigma: float,
                     control_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One transformer evaluation (CFG as one batch of 2 when `ehs` holds
        two rows): the guided velocity in the latents' (1, C, H', W') layout."""
        do_cfg = ehs.shape[0] == 2
        model_in = torch.cat([latents] * 2) if do_cfg else latents
        if control_latents is not None:
            ctrl = torch.cat([control_latents] * 2) if do_cfg else control_latents
            model_in = torch.cat([model_in, ctrl], dim=1)
        # sigma * 1000 and the guidance are formed in fp32, as the jitted JAX step does.
        t = float(np.float32(sigma) * np.float32(1000.0))
        timestep = torch.full((model_in.shape[0],), t, dtype=torch.float32, device=latents.device)
        pred = self.transformer.module(model_in.to(self.spec.transformer_dtype), ehs, timestep,
                                       original_size=sizes, target_size=sizes, crop_coords=crops)
        if do_cfg:
            uncond, cond = pred.chunk(2)
            pred = uncond + float(np.float32(guidance_scale)) * (cond - uncond)
        return pred

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        negative_prompt: Optional[str] = None,
        control_image: Optional[np.ndarray] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
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
        in_channels = self.transformer.config["in_channels"]
        if (control_image is None) != (in_channels == shape[1]):
            raise ValueError(f"a transformer of {in_channels} input channels takes "
                             + ("a control image" if control_image is None else "no control image")
                             + f" ({shape[1]} latent channels)")
        control = None if control_image is None else self.control_latents(control_image, height, width)
        do_cfg = guidance_scale > 1.0
        ehs = self.encode_prompt(prompt, negative_prompt, do_cfg)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32, device=device)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents must have shape {shape}, got {tuple(latents.shape)}")
        sizes = torch.tensor([[height, width]] * ehs.shape[0], dtype=torch.float32, device=device)
        crops = torch.zeros((ehs.shape[0], 2), dtype=torch.float32, device=device)

        sigmas = self.scheduler.inference_sigmas(num_inference_steps)
        sampler = self.scheduler.make_sampler(sigmas)
        for i in range(num_inference_steps):
            pred = self.denoise_step(latents, ehs, sizes, crops, guidance_scale, float(sigmas[i]), control)
            latents = sampler.update(pred, i, latents)

        image = decode_image_vae(self.vae, latents)
        if not torch.isfinite(image).all():
            raise FloatingPointError("the decoded image holds non-finite values")
        image = torch.clamp((image + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (image[0].transpose(1, 2, 0) * 255).astype(np.uint8)  # (H, W, 3)
