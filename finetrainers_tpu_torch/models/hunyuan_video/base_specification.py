"""HunyuanVideo model specification, text-to-video: serving and the training
forward (port of `finetrainers_tpu/models/hunyuan_video/base_specification.py`).

The text towers load from local checkpoint directories, as in JAX (:67-91):
the Llama (LLaVA) tower from `text_encoder/` and CLIP-L's text tower from
`text_encoder_2/` (`text_encoder_2_id`); without one a slot holds the offline
`HashEncoder(4096, max_length=256, pooled_dim=768)` with no template crop
(:70-76). The faithful `AutoencoderKLHunyuanVideo` loads from `vae/` (its
config's scaling factor, 0.476986 without one; :93-113), else the generic
`AutoencoderKL3D` with `HUNYUAN_VAE_CONFIG` serves at random; the
transformer's base weights load from `transformer/` by name (:115-134), else
they are random. Flow-match Euler with shift 7 (:133) unless the checkpoint
directory's scheduler config names another.

As in the JAX package, `prepare_conditions` encodes the pooled CLIP slot with
the Llama slot's encoder when none is given (:156), and `HunyuanVideoPipeline`
gives it none, so serving encodes both slots with one encoder (a JAX bug the
port reproduces; ROADMAP.md section 3, finding 14). With the offline hash
encoder that runs; with a Llama loaded in the first slot JAX fails (its
handle has no pooled output), and the port's `check_serving_text_encoders`
refuses it (`serving_tower_failure`) before the runner or a validating
trainer loads a model.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...logging import get_logger
from ...processors import CaptionTextDropoutProcessor, CLIPPooledProcessor, HashEncoder, LlamaProcessor
from ...schedulers import FlowMatchEulerScheduler, load_scheduler
from ..autoencoders import (HUNYUAN_VAE_CONFIG, AutoencoderConfig, encode_media, generic_vae, media_to_vae_input,
                            sample_from_moments)
from ..layers import init_parameters_
from ..modeling_utils import ModelHandle, ModelSpecification
from .transformer import HunyuanVideoTransformer3DModel


logger = get_logger(__name__)

# Copied from `finetrainers_tpu/models/hunyuan_video/base_specification.py:28-32`.
HUNYUAN_VIDEO_CONFIG = dict(
    in_channels=16, out_channels=16, patch_size=2, patch_size_t=1,
    num_attention_heads=24, attention_head_dim=128, num_layers=20, num_single_layers=40,
    num_refiner_layers=2, text_embed_dim=4096, pooled_projection_dim=768, guidance_embeds=True,
)
SCALING_FACTOR = 0.476986


class HunyuanVideoModelSpecification(ModelSpecification):
    transformer_class_name = "HunyuanVideoTransformer3DModel"
    # JAX :156, pipeline.py:43
    serving_tower_failure = ("serving encodes the pooled CLIP slot with that encoder too, and a Llama tower has no "
                             "pooled output (JAX's FlaxLlamaHandle has no encode_pooled)")

    @staticmethod
    def transformer_key_map(flax_key: str) -> str:
        """The JAX package's flat parameter name -> this module's (an adapter
        saved with flax names loads through it)."""
        from .weights import hunyuan_key_map

        return hunyuan_key_map(flax_key)

    def __init__(
        self,
        pretrained_model_name_or_path: str = "hunyuanvideo-community/HunyuanVideo",
        transformer_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[AutoencoderConfig] = None,
        caption_dropout_p: float = 0.0,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        **kwargs,
    ) -> None:
        super().__init__(pretrained_model_name_or_path=pretrained_model_name_or_path, **kwargs)
        self.transformer_config = {**HUNYUAN_VIDEO_CONFIG, **(transformer_config or {})}
        self.vae_autoencoder_config = vae_config or HUNYUAN_VAE_CONFIG
        self.caption_dropout_p = caption_dropout_p
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.condition_model_processors = [
            CaptionTextDropoutProcessor(caption_dropout_p),
            LlamaProcessor(["encoder_hidden_states", "encoder_attention_mask"]),
            CLIPPooledProcessor(["pooled_projections"], input_names={"text_encoder_2": "text_encoder"}),
        ]

    # ------------------------------------------------------------------ loading
    def _offline_text_encoder(self) -> HashEncoder:
        encoder = HashEncoder(hidden_size=self.transformer_config["text_embed_dim"], max_length=256,
                              pooled_dim=self.transformer_config["pooled_projection_dim"])
        encoder.supports_template_crop = False
        return encoder

    def load_condition_models(self) -> Dict[str, Any]:
        """Llama (`text_encoder`) and CLIP-L text (`text_encoder_2`, pooled)
        from their local directories, each in its slot's dtype, else the
        offline hash encoder in the slot, as JAX falls back (:67-91)."""
        from ..text_encoders import CLIPTextHandle, LlamaHandle

        text_encoder = self._load_text_tower(LlamaHandle, self.text_encoder_id, "text_encoder",
                                             self._offline_text_encoder, tokenizer_id=self.tokenizer_id,
                                             dtype=self.text_encoder_dtype)
        text_encoder_2 = self._load_text_tower(CLIPTextHandle, self.text_encoder_2_id, "text_encoder_2",
                                               self._offline_text_encoder, tokenizer_id=self.tokenizer_2_id,
                                               dtype=self.text_encoder_2_dtype)
        return {"tokenizer": getattr(text_encoder, "tokenizer", None),
                "tokenizer_2": getattr(text_encoder_2, "tokenizer", None),
                "text_encoder": text_encoder, "text_encoder_2": text_encoder_2}

    def load_latent_models(self) -> Dict[str, Any]:
        """The faithful `AutoencoderKLHunyuanVideo` from `vae/`, else the generic VAE (JAX :93-113)."""
        from .vae import AutoencoderKLHunyuanVideo, HunyuanVAEConfig

        handle = self._load_video_vae(AutoencoderKLHunyuanVideo, HunyuanVAEConfig, default_scaling=SCALING_FACTOR)
        if handle is not None:
            return {"vae": handle}
        vae = generic_vae(self, self.vae_autoencoder_config)
        vae.config["scaling_factor"] = SCALING_FACTOR
        return {"vae": vae}

    def load_diffusion_models(self) -> Dict[str, Any]:
        """The transformer, random from the spec's generator, its base weights then
        loaded from a local `transformer/` where there is one (JAX :115-134)."""
        with torch.device(self.device):
            module = HunyuanVideoTransformer3DModel(
                **self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                dtype=self.transformer_dtype, gradient_checkpointing=self.gradient_checkpointing,
            )
        init_parameters_(module, self.generator())
        self._maybe_load_pretrained_transformer(module)
        return {
            "transformer": ModelHandle(module.eval(), dict(self.transformer_config)),
            "scheduler": FlowMatchEulerScheduler(shift=7.0),
        }

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None,
                      text_encoder=None, **kwargs):
        from .pipeline import HunyuanVideoPipeline

        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        if vae is None:
            vae = self.load_latent_models()["vae"]
        if text_encoder is None:
            text_encoder = self.load_condition_models()["text_encoder"]
        return HunyuanVideoPipeline(spec=self, transformer=transformer, vae=vae, text_encoder=text_encoder,
                                    scheduler=load_scheduler(self.pretrained_model_name_or_path,
                                                             default=FlowMatchEulerScheduler(shift=7.0)))

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, text_encoder=None, text_encoder_2=None,
                           max_sequence_length: int = 256, **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, L, C), encoder_attention_mask
        (1, L), pooled_projections (1, P)}; the pooled slot takes `text_encoder`
        where `text_encoder_2` is None (JAX :152-164)."""
        data = {"caption": caption, "text_encoder": text_encoder, "text_encoder_2": text_encoder_2 or text_encoder,
                "max_sequence_length": max_sequence_length}
        for processor in self.condition_model_processors:
            data.update(processor(**data))
        return {
            "encoder_hidden_states": data["encoder_hidden_states"],
            "encoder_attention_mask": data["encoder_attention_mask"],
            "pooled_projections": data["pooled_projections"],
        }

    def prepare_latents(self, vae: ModelHandle, image: Optional[np.ndarray] = None,
                        video: Optional[np.ndarray] = None, compute_posterior: bool = False,
                        **kwargs) -> Dict[str, Any]:
        """An image (C, H, W) or a video (T, C, H, W) in [-1, 1] -> {"latents":
        the VAE's moments (1, 2C, F', H', W'), fp32 on the VAE's device} (JAX :166-173)."""
        if compute_posterior:
            raise NotImplementedError("the port precomputes VAE moments only (compute_posterior=False)")
        device = next(vae.module.parameters()).device
        return {"latents": encode_media(vae, media_to_vae_input(image, video, device))}

    # ---------------------------------------------------------------- training
    def forward(
        self,
        transformer: ModelHandle,
        condition_model_conditions: Dict[str, torch.Tensor],
        latent_model_conditions: Dict[str, torch.Tensor],
        sigmas: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, Any]] = None,
        guidance: float = 1.0,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Flow-matching training forward (JAX :176-205) -> (pred, target, sigmas):
        the moments (B, 2C, F, H, W) sampled, scaled by 0.476986, noised, the
        model with timestep sigmas * 1000 and guidance `guidance` * 1000. The
        draws "posterior" and "noise" (standard normal, the latents' shape)
        come from `draws` where given, else from `generator`."""
        draws = draws or {}
        device = sigmas.device

        def draw(name, shape):
            value = draws.get(name)
            if value is None:
                return torch.randn(shape, generator=generator, device=device)
            return torch.as_tensor(value).to(device).float().reshape(shape)

        moments = latent_model_conditions["latents"].to(device).float()
        shape = (moments.shape[0], moments.shape[1] // 2, *moments.shape[2:])
        latents = sample_from_moments(moments, noise=draw("posterior", shape)) * SCALING_FACTOR
        noise = draw("noise", latents.shape)
        noisy = flow_match_xt(latents, noise, sigmas.reshape(-1, 1, 1, 1, 1))
        mask = condition_model_conditions.get("encoder_attention_mask")
        pred = transformer.module(
            noisy.to(self.transformer_dtype),
            condition_model_conditions["encoder_hidden_states"].to(device),
            sigmas * 1000.0,
            condition_model_conditions["pooled_projections"].to(device),
            encoder_attention_mask=None if mask is None else mask.to(device),
            guidance=torch.full((latents.shape[0],), guidance * 1000.0, dtype=torch.float32, device=device),
        )
        return pred, flow_match_target(noise, latents), sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, height: int = 512, width: int = 512, num_frames: int = 61,
                   num_inference_steps: int = 30, **kwargs) -> List[Any]:
        from ...data import VideoArtifact

        video = pipeline(prompt=prompt, height=height, width=width, num_frames=num_frames,
                         num_inference_steps=num_inference_steps)
        return [VideoArtifact(value=video)]

    @property
    def _resolution_dim_keys(self) -> Dict[str, Tuple[int, ...]]:
        return {"latents": (2, 3, 4)}
