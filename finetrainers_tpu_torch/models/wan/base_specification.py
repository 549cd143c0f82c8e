"""Wan 2.1 model specification, T2V and I2V/FLF2V: serving and the training
forward (port of `finetrainers_tpu/models/wan/base_specification.py`).

From a local diffusers directory (JAX :78-140) the spec loads UMT5 from
`text_encoder/` (`T5Handle`, layer 0's relative-attention table in every
layer as JAX's Flax T5 holds it: ROADMAP.md section 3, finding 24), the
faithful `AutoencoderKLWan` with its latent statistics from `vae/`, and the
transformer's base weights from `transformer/` by name (the LoRA factors stay
fresh). Where a component has no directory it falls back as JAX does: the
offline `HashEncoder(4096, max_length=128)` for text, the generic
`AutoencoderKL3D` with `WAN_VAE_CONFIG` and identity latent statistics, the
transformer's random weights. For I2V the `_OfflineImageEncoder` stands in for
CLIP-vision (:90-97, :294-305); a local `image_encoder/` raises (head dim 80,
and JAX's main path never runs it: finding 2). Serving uses flow-match Euler
with shift 3 (:143, :161-163) unless the directory's scheduler config names
another. `prepare_latents` encodes media into VAE moments (for I2V also the
masked conditioning video's), and `forward` trains on them. The mode is I2V
where the transformer config has an `image_dim` (`WAN_I2V_14B_CONFIG`).

As in the JAX package, the image encoder is loaded but never wired in: the
trainer passes no image to `prepare_conditions`, and `load_pipeline` builds
`WanPipeline` without it, so through these entry points I2V runs the
masked-latent conditioning but not the image-KV branch (a JAX bug the port
reproduces; ROADMAP.md section 3). `load_condition_models` logs it.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...logging import get_logger
from ...processors import CaptionTextDropoutProcessor, T5Processor
from ...schedulers import FlowMatchEulerScheduler, load_scheduler
from ..autoencoders import (WAN_VAE_CONFIG, AutoencoderConfig, encode_media, generic_vae, media_to_vae_input,
                            sample_from_moments)
from ..layers import init_parameters_
from ..modeling_utils import ModelHandle, ModelSpecification
from .transformer import WanTransformer3DModel


logger = get_logger(__name__)

# Copied from `finetrainers_tpu/models/wan/base_specification.py:31-40`.
WAN_T2V_1_3B_CONFIG = dict(
    in_channels=16, out_channels=16, patch_size=(1, 2, 2), num_attention_heads=12,
    attention_head_dim=128, num_layers=30, ffn_dim=8960, text_dim=4096, freq_dim=256,
    image_dim=None,
)
WAN_I2V_14B_CONFIG = dict(
    in_channels=36, out_channels=16, patch_size=(1, 2, 2), num_attention_heads=40,
    attention_head_dim=128, num_layers=40, ffn_dim=13824, text_dim=4096, freq_dim=256,
    image_dim=1280,
)


class WanModelSpecification(ModelSpecification):
    transformer_class_name = "WanTransformer3DModel"

    @staticmethod
    def transformer_key_map(flax_key: str) -> str:
        """The JAX package's flat parameter name -> this module's (an adapter
        saved with flax names loads through it)."""
        from .weights import wan_key_map

        return wan_key_map(flax_key)

    def __init__(
        self,
        pretrained_model_name_or_path: str = "Wan-AI/Wan2.1-T2V-1.3B-Diffusers",
        transformer_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[AutoencoderConfig] = None,
        caption_dropout_p: float = 0.0,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        **kwargs,
    ) -> None:
        super().__init__(pretrained_model_name_or_path=pretrained_model_name_or_path, **kwargs)
        self.transformer_config = {**WAN_T2V_1_3B_CONFIG, **(transformer_config or {})}
        self.vae_autoencoder_config = vae_config or WAN_VAE_CONFIG
        self.caption_dropout_p = caption_dropout_p
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.condition_model_processors = [
            CaptionTextDropoutProcessor(caption_dropout_p),
            T5Processor(["encoder_hidden_states", "encoder_attention_mask"]),
        ]

    @property
    def is_i2v(self) -> bool:
        return self.transformer_config.get("image_dim") is not None

    # ------------------------------------------------------------------ loading
    def load_condition_models(self) -> Dict[str, Any]:
        """UMT5 from a local directory, else the offline hash encoder (JAX :80-90)."""
        encoder = self._load_t5(self.transformer_config["text_dim"], max_length=128)
        out = {"tokenizer": getattr(encoder, "tokenizer", None), "text_encoder": encoder}
        if self.is_i2v:
            self._refuse_checkpoint(None, "image_encoder", "the CLIP-vision image encoder")
            out["image_encoder"] = _OfflineImageEncoder(self.transformer_config["image_dim"])
            logger.warning(
                "Wan I2V: the image encoder is loaded but, as in the JAX package, neither the trainer nor "
                "load_pipeline passes it on, so the image-KV branch does not run (only the masked-latent "
                "conditioning does); build WanPipeline(..., image_encoder=...) to run it")
        return out

    def load_latent_models(self) -> Dict[str, Any]:
        """The faithful `AutoencoderKLWan` from `vae/`, else the generic VAE (JAX :102-124)."""
        from .vae import AutoencoderKLWan, WanVAEConfig

        handle = self._load_video_vae(AutoencoderKLWan, WanVAEConfig)
        if handle is not None:
            return {"vae": handle}
        return {"vae": generic_vae(self, self.vae_autoencoder_config)}

    def _build_transformer(self, config: Dict[str, Any], pretrained: bool = False) -> ModelHandle:
        """The transformer at `config`, random from the spec's generator; with
        `pretrained` its base weights then load from a local `transformer/`
        (JAX :126-140), else a local one raises (the control spec's widened
        model, ROADMAP.md section 3 finding 19)."""
        if not pretrained:
            self._refuse_checkpoint(self.transformer_id, "transformer", "a control model's transformer weights "
                                    "(ROADMAP.md section 3 finding 19, queue 1 item 5)")
        with torch.device(self.device):
            module = WanTransformer3DModel(
                **config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                dtype=self.transformer_dtype, gradient_checkpointing=self.gradient_checkpointing,
            )
        init_parameters_(module, self.generator())
        if pretrained:
            self._maybe_load_pretrained_transformer(module)
        return ModelHandle(module.eval(), dict(config))

    def load_diffusion_models(self) -> Dict[str, Any]:
        return {"transformer": self._build_transformer(self.transformer_config, pretrained=True),
                "scheduler": FlowMatchEulerScheduler(shift=3.0)}

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None,
                      text_encoder=None, **kwargs):
        from .pipeline import WanPipeline

        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        if vae is None:
            vae = self.load_latent_models()["vae"]
        if text_encoder is None:
            text_encoder = self.load_condition_models()["text_encoder"]
        # Wan 2.1 checkpoints ship UniPC in their scheduler config; flow-match
        # Euler with shift 3 is the fallback. No image encoder, as in JAX (:146-159).
        return WanPipeline(
            spec=self, transformer=transformer, vae=vae, text_encoder=text_encoder,
            scheduler=load_scheduler(self.pretrained_model_name_or_path, default=FlowMatchEulerScheduler(shift=3.0)),
        )

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, text_encoder=None, max_sequence_length: int = 512,
                           image=None, image_encoder=None, **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, L, C), encoder_attention_mask (1, L)};
        for I2V with both an image and an image encoder also
        "encoder_hidden_states_image" (1, 257, image_dim) (JAX :166-177)."""
        data = {"caption": caption, "text_encoder": text_encoder, "max_sequence_length": max_sequence_length}
        for processor in self.condition_model_processors:
            data.update(processor(**data))
        out = {
            "encoder_hidden_states": data["encoder_hidden_states"],
            "encoder_attention_mask": data["encoder_attention_mask"],
        }
        if self.is_i2v and image is not None and image_encoder is not None:
            out["encoder_hidden_states_image"] = image_encoder.encode_image(np.asarray(image))
        return out

    def prepare_latents(self, vae: ModelHandle, image: Optional[np.ndarray] = None,
                        video: Optional[np.ndarray] = None, compute_posterior: bool = False,
                        last_image: Optional[np.ndarray] = None, **kwargs) -> Dict[str, Any]:
        """Media -> {"latents": the VAE's moments (1, 2C, F', H', W'), fp32 on
        the VAE's device; "latents_mean"/"latents_std" (C,) numpy}: an image
        (C, H, W) or a video (T, C, H, W) in [-1, 1] through `encode_media`
        (JAX :179-213). The trainer samples the posterior in `forward`, so
        `compute_posterior` must stay False.

        For I2V also "latent_condition", the moments of the conditioning video
        (the first frame kept, the rest zeroed; with `last_image` (C, H, W), FLF2V,
        the last frame set to it), and "latent_condition_mask" (1, t_down, F',
        H', W'): ones on the first latent frame, and with `last_image` on the
        last frame's first channel."""
        if compute_posterior:
            raise NotImplementedError("the port precomputes VAE moments only (compute_posterior=False)")
        device = next(vae.module.parameters()).device
        x = media_to_vae_input(image, video, device)
        moments = encode_media(vae, x)
        out = {
            "latents": moments,
            "latents_mean": vae.config["latents_mean"],
            "latents_std": vae.config["latents_std"],
        }
        if self.is_i2v:
            cond_video = x.clone()
            cond_video[:, :, 1:] = 0.0
            if last_image is not None:
                cond_video[:, :, -1:] = torch.as_tensor(np.asarray(last_image, np.float32), device=device)[None, :, None]
            mask = torch.zeros((1, vae.config["temporal_compression_ratio"], *moments.shape[2:]), device=device)
            mask[:, :, 0] = 1.0
            if last_image is not None:
                mask[:, 0, -1] = 1.0
            out["latent_condition"] = encode_media(vae, cond_video)
            out["latent_condition_mask"] = mask
        return out

    def collate_latents(self, data: List[Dict[str, Any]]) -> Dict[str, Any]:
        """The moments joined on the batch dim; the channel statistics, equal
        across samples, stay (C,)."""
        out = super().collate_latents(data)
        out["latents_mean"] = np.asarray(data[0]["latents_mean"]).reshape(-1)
        out["latents_std"] = np.asarray(data[0]["latents_std"]).reshape(-1)
        return out

    # ---------------------------------------------------------------- training
    @staticmethod
    def _normalize_moments(moments: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
        """(x - mean) / std per channel on BOTH halves of the moments, mean and
        log-variance alike (JAX :222-228, a quirk of the reference trainer)."""
        mean, std = mean.reshape(1, -1, 1, 1, 1), std.reshape(1, -1, 1, 1, 1)
        mu, logvar = moments.float().chunk(2, dim=1)
        return torch.cat([(mu - mean) / std, (logvar - mean) / std], dim=1)

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
        """Flow-matching training forward (JAX :230-266) -> (pred, target, sigmas).

        latent_model_conditions: "latents" (VAE moments (B, 2C, F, H, W)),
        "latents_mean"/"latents_std" (C,). condition_model_conditions:
        "encoder_hidden_states", optional "encoder_attention_mask". The moments
        are normalised, then sampled; the two random draws of the JAX forward
        are taken from `draws` where given, else from `generator`: "posterior"
        and "noise" (standard normal, latent shape). One timestep per sample,
        sigmas * 1000; the posterior is always sampled (`compute_posterior` is
        forced False in the reference). For I2V the noisy latents are joined on
        the channel axis by "latent_condition_mask" and the normalised
        "latent_condition"'s mean (its posterior mode), and
        "encoder_hidden_states_image", where the conditions hold it, reaches
        the image-KV branch."""
        draws = draws or {}
        device = sigmas.device

        def draw(name, shape):
            value = draws.get(name)
            if value is None:
                return torch.randn(shape, generator=generator, device=device)
            return torch.as_tensor(value).to(device).float()

        moments = self._normalize_moments(latent_model_conditions["latents"].to(device),
                                          latent_model_conditions["latents_mean"].to(device),
                                          latent_model_conditions["latents_std"].to(device))
        shape = (moments.shape[0], moments.shape[1] // 2, *moments.shape[2:])
        latents = sample_from_moments(moments, noise=draw("posterior", shape))
        noise = draw("noise", latents.shape)
        noisy = flow_match_xt(latents, noise, sigmas.reshape(-1, 1, 1, 1, 1))
        if self.is_i2v:
            cond = self._normalize_moments(latent_model_conditions["latent_condition"].to(device),
                                           latent_model_conditions["latents_mean"].to(device),
                                           latent_model_conditions["latents_std"].to(device))
            noisy = torch.cat([noisy, latent_model_conditions["latent_condition_mask"].to(device).float(),
                               cond.chunk(2, dim=1)[0]], dim=1)
        mask = condition_model_conditions.get("encoder_attention_mask")
        image_embeds = condition_model_conditions.get("encoder_hidden_states_image")
        pred = transformer.module(
            noisy.to(self.transformer_dtype),
            condition_model_conditions["encoder_hidden_states"].to(device),
            sigmas * 1000.0,
            encoder_attention_mask=None if mask is None else mask.to(device),
            encoder_hidden_states_image=None if image_embeds is None else image_embeds.to(device),
        )
        return pred, flow_match_target(noise, latents), sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, image=None, height: int = 480, width: int = 832,
                   num_frames: int = 81, num_inference_steps: int = 50, **kwargs) -> List[Any]:
        from ...data import VideoArtifact

        video = pipeline(prompt=prompt, image=image, height=height, width=width, num_frames=num_frames,
                         num_inference_steps=num_inference_steps)
        return [VideoArtifact(value=video)]


class _OfflineImageEncoder:
    """The JAX package's deterministic CLIP-vision stand-in (:294-305): (1, 257,
    dim) normal * 0.02 embeds from a RandomState seeded with the image bytes'
    sha256, so both packages give the same bytes for the same image array."""

    def __init__(self, dim: int):
        self.dim = dim

    def encode_image(self, image: np.ndarray) -> np.ndarray:
        digest = hashlib.sha256(np.ascontiguousarray(image).tobytes()).digest()
        seed = int.from_bytes(digest[:4], "little")
        return np.random.RandomState(seed).randn(1, 257, self.dim).astype(np.float32) * 0.02
