"""LTX-Video model specification: serving and the training forward (port of
`finetrainers_tpu/models/ltx_video/base_specification.py`).

From a local diffusers directory (JAX :78-133) the spec loads T5-XXL v1.1
from `text_encoder/` (`T5Handle`), the faithful `AutoencoderKLLTXVideo` from
`vae/` (its compression ratios replace the spec's), and the transformer's
base weights from `transformer/` by name (the LoRA factors stay fresh).
Without a directory a component falls back as JAX's does: `HashEncoder` for
text, the generic `AutoencoderKL3D` with `LTX_VAE_CONFIG`, random transformer
weights. `prepare_latents` encodes media into VAE moments, and `forward`
trains on them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...logging import get_logger
from ...processors import CaptionTextDropoutProcessor, T5Processor
from ...schedulers import FlowMatchEulerScheduler, load_scheduler
from ..autoencoders import (LTX_VAE_CONFIG, AutoencoderConfig, encode_media, generic_vae, media_to_vae_input,
                            sample_from_moments)
from ..layers import init_parameters_
from ..modeling_utils import ModelHandle, ModelSpecification
from .transformer import LTXVideoTransformer3DModel, pack_latents


logger = get_logger(__name__)

LTX_TRANSFORMER_CONFIG = dict(
    in_channels=128, out_channels=128, patch_size=1, patch_size_t=1,
    num_attention_heads=32, attention_head_dim=64, cross_attention_dim=2048,
    num_layers=28, caption_channels=4096,
)


class LTXVideoModelSpecification(ModelSpecification):
    transformer_class_name = "LTXVideoTransformer3DModel"

    @staticmethod
    def transformer_key_map(flax_key: str) -> str:
        """The JAX package's flat parameter name -> this module's (an adapter
        saved with flax names loads through it)."""
        from .weights import ltx_key_map

        return ltx_key_map(flax_key)

    first_frame_conditioning_p = 0.1
    min_first_frame_sigma = 0.25
    frame_rate = 25

    def __init__(
        self,
        pretrained_model_name_or_path: str = "Lightricks/LTX-Video",
        transformer_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[AutoencoderConfig] = None,
        caption_dropout_p: float = 0.0,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        **kwargs,
    ) -> None:
        super().__init__(pretrained_model_name_or_path=pretrained_model_name_or_path, **kwargs)
        self.transformer_config = {**LTX_TRANSFORMER_CONFIG, **(transformer_config or {})}
        self.vae_autoencoder_config = vae_config or LTX_VAE_CONFIG
        self.vae_spatial_compression_ratio = self.vae_autoencoder_config.spatial_compression_ratio
        self.vae_temporal_compression_ratio = self.vae_autoencoder_config.temporal_compression_ratio
        self.caption_dropout_p = caption_dropout_p
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.condition_model_processors = [
            CaptionTextDropoutProcessor(caption_dropout_p),
            T5Processor(["encoder_hidden_states", "encoder_attention_mask"]),
        ]

    # ------------------------------------------------------------------ loading
    def load_condition_models(self) -> Dict[str, Any]:
        """T5 from a local directory, else the offline hash encoder (JAX :78-89)."""
        encoder = self._load_t5(self.transformer_config["caption_channels"], max_length=128)
        return {"tokenizer": getattr(encoder, "tokenizer", None), "text_encoder": encoder}

    def load_latent_models(self) -> Dict[str, Any]:
        """The faithful `AutoencoderKLLTXVideo` from `vae/`, whose compression
        ratios the spec then takes, else the generic VAE (JAX :91-113)."""
        from .vae import AutoencoderKLLTXVideo, LTXVAEConfig

        handle = self._load_video_vae(AutoencoderKLLTXVideo, LTXVAEConfig)
        if handle is not None:
            self.vae_spatial_compression_ratio = handle.config["spatial_compression_ratio"]
            self.vae_temporal_compression_ratio = handle.config["temporal_compression_ratio"]
            return {"vae": handle}
        return {"vae": generic_vae(self, self.vae_autoencoder_config)}

    def load_diffusion_models(self) -> Dict[str, Any]:
        """The transformer, random from the spec's generator, its base weights
        then loaded from a local `transformer/` (JAX :115-133)."""
        with torch.device(self.device):
            module = LTXVideoTransformer3DModel(
                **self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                dtype=self.transformer_dtype, gradient_checkpointing=self.gradient_checkpointing,
            )
        init_parameters_(module, self.generator())
        self._maybe_load_pretrained_transformer(module)
        return {
            "transformer": ModelHandle(module.eval(), dict(self.transformer_config)),
            "scheduler": FlowMatchEulerScheduler(),
        }

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None,
                      text_encoder=None, **kwargs):
        from .pipeline import LTXPipeline

        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        if vae is None:
            vae = self.load_latent_models()["vae"]
        if text_encoder is None:
            text_encoder = self.load_condition_models()["text_encoder"]
        return LTXPipeline(
            spec=self, transformer=transformer, vae=vae, text_encoder=text_encoder,
            scheduler=load_scheduler(self.pretrained_model_name_or_path, default=FlowMatchEulerScheduler()),
        )

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, text_encoder=None, max_sequence_length: int = 128,
                           **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, L, C), encoder_attention_mask (1, L)}."""
        data = {"caption": caption, "text_encoder": text_encoder, "max_sequence_length": max_sequence_length}
        for processor in self.condition_model_processors:
            data.update(processor(**data))
        return {
            "encoder_hidden_states": data["encoder_hidden_states"],
            "encoder_attention_mask": data["encoder_attention_mask"],
        }

    def prepare_latents(self, vae: ModelHandle, image: Optional[np.ndarray] = None,
                        video: Optional[np.ndarray] = None, compute_posterior: bool = False,
                        **kwargs) -> Dict[str, Any]:
        """Media -> {"latents": the VAE's moments (1, 2C, F', H', W'), fp32 on
        the VAE's device; "latents_mean"/"latents_std" (C,) numpy}: an image
        (C, H, W) or a video (T, C, H, W) in [-1, 1] through `encode_media`
        (JAX base_specification.py, `prepare_latents`). The trainer samples
        the posterior in `forward`, so `compute_posterior` must stay False."""
        if compute_posterior:
            raise NotImplementedError("the port precomputes VAE moments only (compute_posterior=False)")
        device = next(vae.module.parameters()).device
        return {
            "latents": encode_media(vae, media_to_vae_input(image, video, device)),
            "latents_mean": vae.config["latents_mean"],
            "latents_std": vae.config["latents_std"],
        }

    def collate_latents(self, data: List[Dict[str, Any]]) -> Dict[str, Any]:
        """The moments joined on the batch dim; the channel statistics, equal
        across samples, stay (C,)."""
        out = super().collate_latents(data)
        out["latents_mean"] = np.asarray(data[0]["latents_mean"]).reshape(-1)
        out["latents_std"] = np.asarray(data[0]["latents_std"]).reshape(-1)
        return out

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
        """Flow-matching training forward (JAX :196-256) -> (pred, target, sigmas).

        latent_model_conditions: "latents" (VAE moments (B, 2C, F, H, W)),
        "latents_mean"/"latents_std" (C,).
        condition_model_conditions: "encoder_hidden_states", optional
        "encoder_attention_mask". The four random draws of the JAX forward are
        taken from `draws` where given, else from `generator`: "posterior" and
        "noise" (standard normal, latent shape), "first_frame" (the one coin of
        stochastic first-frame conditioning, p = 0.1) and "first_frame_u"
        (uniform (B,)). With the coin up, the first latent frame is noised to
        min(u * sigma, 0.25) instead of sigma; timesteps are per token."""
        draws = draws or {}
        device = sigmas.device

        def draw(name, make):
            value = draws.get(name)
            return make() if value is None else torch.as_tensor(value).to(device)

        moments = latent_model_conditions["latents"].to(device)
        shape = (moments.shape[0], moments.shape[1] // 2, *moments.shape[2:])
        latents = sample_from_moments(moments, noise=draw(
            "posterior", lambda: torch.randn(shape, generator=generator, device=device, dtype=moments.dtype)))
        mean = latent_model_conditions["latents_mean"].to(device).reshape(1, -1, 1, 1, 1)
        std = latent_model_conditions["latents_std"].to(device).reshape(1, -1, 1, 1, 1)
        latents = (latents.float() - mean) / std

        noise = draw("noise", lambda: torch.randn(latents.shape, generator=generator, device=device)).float()
        sigmas_e = sigmas.reshape(-1, 1, 1, 1, 1)
        use_ff = draw("first_frame", lambda: torch.rand((), generator=generator, device=device)
                      < self.first_frame_conditioning_p).bool()
        ff_u = draw("first_frame_u", lambda: torch.rand(sigmas.shape, generator=generator, device=device))
        ff_sigma = torch.clamp(ff_u.float() * sigmas, max=self.min_first_frame_sigma)
        first_frame_sigma = torch.where(use_ff, ff_sigma.reshape(-1, 1, 1, 1, 1), sigmas_e)
        frame_idx = torch.arange(latents.shape[2], device=device).reshape(1, 1, -1, 1, 1)
        sigma_map = torch.where(frame_idx == 0, first_frame_sigma, sigmas_e)

        noisy = flow_match_xt(latents, noise, sigma_map)

        cfg = self.transformer_config
        p, pt = cfg["patch_size"], cfg["patch_size_t"]
        num_frames, height, width = latents.shape[2], latents.shape[3], latents.shape[4]
        token_sigmas = pack_latents(sigma_map.expand(latents.shape), p, pt)[..., 0]
        latent_frame_rate = self.frame_rate / self.vae_temporal_compression_ratio
        rope_interpolation_scale = (
            1.0 / latent_frame_rate,
            float(self.vae_spatial_compression_ratio),
            float(self.vae_spatial_compression_ratio),
        )
        mask = condition_model_conditions.get("encoder_attention_mask")
        pred = transformer.module(
            pack_latents(noisy, p, pt).to(self.transformer_dtype),
            condition_model_conditions["encoder_hidden_states"].to(device),
            token_sigmas * 1000.0,
            encoder_attention_mask=None if mask is None else mask.to(device),
            num_frames=num_frames, height=height, width=width,
            rope_interpolation_scale=rope_interpolation_scale,
        )
        target = flow_match_target(pack_latents(noise, p, pt), pack_latents(latents, p, pt))
        return pred, target, sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, image=None, height: int = 512, width: int = 704,
                   num_frames: int = 49, frame_rate: int = 25, num_inference_steps: int = 50,
                   **kwargs) -> List[Any]:
        from ...data import VideoArtifact

        video = pipeline(
            prompt=prompt, image=image, height=height, width=width, num_frames=num_frames,
            frame_rate=frame_rate, num_inference_steps=num_inference_steps,
        )
        return [VideoArtifact(value=video)]
