"""Wan 2.1 text- and image-to-video pipeline (port of
`finetrainers_tpu/models/wan/pipeline.py`), with the scheduler the spec
loads (the checkpoint's UniPC, or flow-match Euler with shift 3).

Image-to-video (JAX :48-75, :118-130): the image is placed as the first frame
of an otherwise zero video at the request's size, encoded whole by the VAE
(its raw posterior mean, not normalised: a JAX bug the port reproduces,
ROADMAP.md section 3), and joined with the first-frame mask to the latents on
the channel axis in every denoise step. Where the pipeline has an
`image_encoder`, its embeds reach the image-KV branch, repeated over the CFG
batch; `load_pipeline` leaves it unset, as JAX does.

Control conditioning (JAX :77-108, :116-119), for a model whose patch
embedding the control trainer widened: a `control_video` (uint8 (F, H, W, 3)
or float (F, 3, H, W) in [-1, 1]; a `control_image` is one frame) is resized
and cropped to the request's size, placed in a zero video of the request's
frames, encoded whole, normalised with the latent statistics, and its
posterior mean masked by the spec's frame-conditioning type; these channels
join the latents (after the I2V channels) in every denoise step. The
`prefix` and `random` types draw from a generator seeded with the request's
seed (JAX draws from `PRNGKey(seed)`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ...schedulers import FlowMatchEulerScheduler
from ..autoencoders import encode_media
from ..modeling_utils import ModelHandle


@dataclasses.dataclass
class WanPipeline:
    spec: Any
    transformer: ModelHandle
    vae: ModelHandle
    text_encoder: Any
    scheduler: FlowMatchEulerScheduler
    image_encoder: Any = None

    def latent_shape(self, num_frames: int, height: int, width: int):
        """(1, C, F', H', W') of the latents for a video of the given size."""
        sr = self.vae.config["spatial_compression_ratio"]
        tr = self.vae.config["temporal_compression_ratio"]
        return (1, self.vae.config["latent_channels"], (num_frames - 1) // tr + 1, height // sr, width // sr)

    def encode_prompt(self, prompt: str, negative_prompt: Optional[str], do_cfg: bool, image=None):
        """Text path -> (encoder_hidden_states, mask, image embeds or None) on
        the device; with CFG the batch is [uncond, cond], and the image embeds
        (where an image and the pipeline's image encoder give them) repeat."""
        spec = self.spec
        conds = spec.prepare_conditions(caption=prompt, text_encoder=self.text_encoder, image=image,
                                        image_encoder=self.image_encoder)
        ehs, mask = conds["encoder_hidden_states"], conds["encoder_attention_mask"]
        img_embeds = conds.get("encoder_hidden_states_image")
        if do_cfg:
            neg = spec.prepare_conditions(caption=negative_prompt or "", text_encoder=self.text_encoder)
            ehs = np.concatenate([neg["encoder_hidden_states"], ehs])
            mask = np.concatenate([neg["encoder_attention_mask"], mask])
            if img_embeds is not None:
                img_embeds = np.concatenate([img_embeds, img_embeds])
        if img_embeds is not None:
            img_embeds = torch.from_numpy(img_embeds).to(spec.device)
        return torch.from_numpy(ehs).to(spec.device), torch.from_numpy(mask).to(spec.device), img_embeds

    def image_condition(self, image, num_frames: int, height: int, width: int) -> torch.Tensor:
        """The I2V channels (1, t_down + C, F', H', W'): the first-frame mask and
        the VAE's raw posterior mean of the image placed as frame 0 of a zero
        video at the request's size (a uint8 (H, W, 3) image is mapped to [-1, 1]
        first; JAX :63-75)."""
        img = np.asarray(image, np.float32)
        if img.ndim == 3 and img.shape[-1] == 3:
            img = np.moveaxis(img / 127.5 - 1.0, -1, 0)
        frames = torch.zeros((1, 3, num_frames, height, width), dtype=torch.float32, device=self.spec.device)
        frames[:, :, 0] = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.spec.device)
        cond_latents = self.vae.module.encode(frames).chunk(2, dim=1)[0]
        mask = torch.zeros((1, self.vae.config["temporal_compression_ratio"], *cond_latents.shape[2:]),
                           dtype=torch.float32, device=self.spec.device)
        mask[:, :, 0] = 1.0
        return torch.cat([mask, cond_latents], dim=1)

    def control_channels(self, control_video, num_frames: int, height: int, width: int, seed: int) -> torch.Tensor:
        """The control channels (1, C or 2C with the mask, F', H', W') of a
        control video (JAX :82-108)."""
        from ...functional.video import resize_crop_video

        spec, device = self.spec, self.spec.device
        vid = np.asarray(control_video)
        if vid.dtype == np.uint8:
            vid = np.moveaxis(vid.astype(np.float32) / 127.5 - 1.0, -1, 1)
        vid = resize_crop_video(np.asarray(vid, np.float32), (height, width))
        frames = torch.zeros((1, 3, num_frames, height, width), dtype=torch.float32, device=device)
        n = min(num_frames, vid.shape[0])
        frames[0, :, :n] = torch.from_numpy(np.ascontiguousarray(vid[:n].transpose(1, 0, 2, 3))).to(device)
        moments = encode_media(self.vae, frames)
        mean = torch.as_tensor(self.vae.config["latents_mean"], dtype=torch.float32, device=device)
        std = torch.as_tensor(self.vae.config["latents_std"], dtype=torch.float32, device=device)
        return spec.control_channels(moments, mean, std, generator=torch.Generator(device=device).manual_seed(seed))

    def denoise_step(self, latents: torch.Tensor, ehs: torch.Tensor, mask: torch.Tensor, guidance_scale: float,
                     sigma: float, img_embeds: Optional[torch.Tensor] = None,
                     cond_channels: Optional[torch.Tensor] = None,
                     control_channels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One transformer evaluation (CFG as one batch of 2 when `ehs` holds two
        rows): the guided velocity in the latents' (1, C, F', H', W') layout.
        I2V's `cond_channels`, then the control channels, join the latents on
        the channel axis first."""
        do_cfg = ehs.shape[0] == 2
        model_in = latents if cond_channels is None else torch.cat([latents, cond_channels], dim=1)
        if control_channels is not None:
            model_in = torch.cat([model_in, control_channels], dim=1)
        model_in = torch.cat([model_in] * 2) if do_cfg else model_in
        # sigma * 1000 and the guidance are formed in fp32, as the jitted JAX step does.
        t = float(np.float32(sigma) * np.float32(1000.0))
        timestep = torch.full((model_in.shape[0],), t, dtype=torch.float32, device=latents.device)
        pred = self.transformer.module(model_in.to(self.spec.transformer_dtype), ehs, timestep,
                                       encoder_attention_mask=mask, encoder_hidden_states_image=img_embeds)
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
        from `torch.Generator(device).manual_seed(seed)`. `image` (uint8 (H, W,
        3) or float (3, H, W) in [-1, 1], at the request's size) conditions an
        I2V model; a T2V model ignores it, as in JAX."""
        device = self.spec.device
        shape = self.latent_shape(num_frames, height, width)
        ehs, mask, img_embeds = self.encode_prompt(prompt, negative_prompt, guidance_scale > 1.0, image)
        if latents is None:
            generator = torch.Generator(device=device).manual_seed(seed)
            latents = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32, device=device)
            if tuple(latents.shape) != shape:
                raise ValueError(f"latents must have shape {shape}, got {tuple(latents.shape)}")

        cond_channels = None
        if self.spec.is_i2v and image is not None:
            cond_channels = self.image_condition(image, num_frames, height, width)
        if control_video is None and control_image is not None:
            control_video = np.asarray(control_image)[None]
        control = None
        if control_video is not None:
            if not hasattr(self.spec, "control_channels"):
                raise ValueError("a control video needs a control model (--training_type control-lora or "
                                 "control-full-finetune)")
            control = self.control_channels(control_video, num_frames, height, width, seed)
        in_channels = self.transformer.config["in_channels"]
        given = shape[1] + sum(c.shape[1] for c in (cond_channels, control) if c is not None)
        if given != in_channels:
            raise ValueError(f"a transformer of {in_channels} input channels takes {given} here: a control model "
                             "needs a control video (or image) and a model without control none")

        sigmas = self.scheduler.inference_sigmas(num_inference_steps)
        sampler = self.scheduler.make_sampler(sigmas)
        for i in range(num_inference_steps):
            pred = self.denoise_step(latents, ehs, mask, guidance_scale, float(sigmas[i]), img_embeds, cond_channels,
                                     control)
            latents = sampler.update(pred, i, latents)  # the guided prediction: UniPC's history takes it

        mean = torch.as_tensor(self.vae.config["latents_mean"], device=device).reshape(1, -1, 1, 1, 1)
        std = torch.as_tensor(self.vae.config["latents_std"], device=device).reshape(1, -1, 1, 1, 1)
        video = self.vae.module.decode(latents * std + mean)
        if not torch.isfinite(video).all():
            raise FloatingPointError("the decoded video holds non-finite values")
        video = torch.clamp((video + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        return (video[0].transpose(1, 2, 3, 0) * 255).astype(np.uint8)  # (F, H, W, 3)
