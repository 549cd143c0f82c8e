"""Wan 2.1 model specification: text-to-video serving and the training forward
(port of the T2V parts of `finetrainers_tpu/models/wan/base_specification.py`).

Random weights only: no UMT5, Wan VAE or Wan transformer checkpoint exists
for the port yet, so it serves with the offline components the JAX package
falls back to: `HashEncoder(4096, max_length=128)` for text (:85-88), the
generic `AutoencoderKL3D` with `WAN_VAE_CONFIG` and identity latent statistics
(:106-120), and flow-match Euler with shift 3 (:143, :161-163). A local
checkpoint directory for any component raises NotImplementedError instead of
being ignored. `forward` trains on precomputed VAE moments. Image-to-video
(`image_dim`, the CLIP-vision encoder) and encoding media (`prepare_latents`)
are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...logging import get_logger
from ...processors import CaptionTextDropoutProcessor, HashEncoder, T5Processor
from ...schedulers import FlowMatchEulerScheduler, load_scheduler
from ..autoencoders import WAN_VAE_CONFIG, AutoencoderConfig, generic_vae, sample_from_moments
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
        self._refuse_checkpoint(self.text_encoder_id, "text_encoder", "the UMT5 text encoder")
        if self.is_i2v:
            raise NotImplementedError("the Wan image encoder is not ported yet; see ROADMAP.md queue 1 (Wan I2V)")
        logger.warning("UMT5 is not ported; using the offline hash encoder")
        encoder = HashEncoder(hidden_size=self.transformer_config["text_dim"], max_length=128)
        return {"tokenizer": None, "text_encoder": encoder}

    def load_latent_models(self) -> Dict[str, Any]:
        return {"vae": generic_vae(self, self.vae_autoencoder_config, "the Wan VAE")}

    def load_diffusion_models(self) -> Dict[str, Any]:
        self._refuse_checkpoint(self.transformer_id, "transformer", "transformer weights")
        with torch.device(self.device):
            module = WanTransformer3DModel(
                **self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                dtype=self.transformer_dtype, gradient_checkpointing=self.gradient_checkpointing,
            )
        init_parameters_(module, self.generator()).eval()
        return {
            "transformer": ModelHandle(module, dict(self.transformer_config)),
            "scheduler": FlowMatchEulerScheduler(shift=3.0),
        }

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None,
                      text_encoder=None, **kwargs):
        from .pipeline import WanPipeline

        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        if vae is None:
            vae = self.load_latent_models()["vae"]
        if text_encoder is None:
            text_encoder = self.load_condition_models()["text_encoder"]
        # Wan 2.1 checkpoints ship UniPC in their scheduler config (not ported:
        # load_scheduler raises for it); flow-match Euler with shift 3 is the fallback.
        return WanPipeline(
            spec=self, transformer=transformer, vae=vae, text_encoder=text_encoder,
            scheduler=load_scheduler(self.pretrained_model_name_or_path, default=FlowMatchEulerScheduler(shift=3.0)),
        )

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, text_encoder=None, max_sequence_length: int = 512,
                           **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, L, C), encoder_attention_mask (1, L)}."""
        data = {"caption": caption, "text_encoder": text_encoder, "max_sequence_length": max_sequence_length}
        for processor in self.condition_model_processors:
            data.update(processor(**data))
        return {
            "encoder_hidden_states": data["encoder_hidden_states"],
            "encoder_attention_mask": data["encoder_attention_mask"],
        }

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
        """Flow-matching training forward, text-to-video (JAX :230-266) -> (pred,
        target, sigmas).

        latent_model_conditions: "latents" (VAE moments (B, 2C, F, H, W)),
        "latents_mean"/"latents_std" (C,). condition_model_conditions:
        "encoder_hidden_states", optional "encoder_attention_mask". The moments
        are normalised, then sampled; the two random draws of the JAX forward
        are taken from `draws` where given, else from `generator`: "posterior"
        and "noise" (standard normal, latent shape). One timestep per sample,
        sigmas * 1000; the posterior is always sampled (`compute_posterior` is
        forced False in the reference)."""
        if self.is_i2v:
            raise NotImplementedError("Wan image-to-video training is not ported yet; see ROADMAP.md queue 1 (Wan I2V)")
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
        mask = condition_model_conditions.get("encoder_attention_mask")
        pred = transformer.module(
            noisy.to(self.transformer_dtype),
            condition_model_conditions["encoder_hidden_states"].to(device),
            sigmas * 1000.0,
            encoder_attention_mask=None if mask is None else mask.to(device),
        )
        return pred, flow_match_target(noise, latents), sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, image=None, height: int = 480, width: int = 832,
                   num_frames: int = 81, num_inference_steps: int = 50, **kwargs) -> List[Any]:
        from ...data import VideoArtifact

        video = pipeline(prompt=prompt, image=image, height=height, width=width, num_frames=num_frames,
                         num_inference_steps=num_inference_steps)
        return [VideoArtifact(value=video)]
