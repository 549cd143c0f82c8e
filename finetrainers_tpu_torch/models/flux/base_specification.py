"""Flux model specification, text-to-image: serving and the training forward
(port of `finetrainers_tpu/models/flux/base_specification.py`).

Each component loads from a local diffusers directory, as in JAX (:74-141):
CLIP-L's text tower from `text_encoder/` (`CLIPTextHandle`, pooled) and
T5-XXL from `text_encoder_2/` (`T5Handle`), each else the offline
`HashEncoder(4096, max_length=512, pooled_dim=768)` (:79-97); the 2D
`AutoencoderKL` from `vae/` (its config's latent statistics, 0.3611 and
0.1159 without them), else the generic `AutoencoderKL3D` with `SD_VAE_CONFIG`
on single frames (:105-118); the transformer's base weights from
`transformer/` by name (:120-141). Flow-match Euler with dynamic shifting
(:137) unless the checkpoint directory's scheduler config names another.

As in the JAX package, `prepare_conditions` encodes the T5 slot with the
CLIP slot's encoder when none is given (:161), and `FluxPipeline` gives it
none, so serving encodes both slots with one encoder (a JAX bug the port
reproduces; ROADMAP.md section 3 finding 14). With the offline hash encoder
that runs; with CLIP-L loaded in the first slot its 768-wide states reach a
context embedder that takes 4096 and JAX fails, and the port's
`check_serving_text_encoders` refuses it (`serving_tower_failure`) before
the runner or a validating trainer loads a model.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...processors import CaptionTextDropoutProcessor, CLIPPooledProcessor, HashEncoder, T5Processor
from ...schedulers import FlowMatchEulerScheduler, load_scheduler
from ..autoencoders import SD_VAE_CONFIG, AutoencoderConfig, encode_image_vae, generic_vae, sample_from_moments
from ..layers import init_parameters_
from ..modeling_utils import ModelHandle, ModelSpecification
from .transformer import FluxTransformer2DModel, pack_flux_latents, prepare_latent_image_ids, unpack_flux_latents


# Copied from `finetrainers_tpu/models/flux/base_specification.py:34-38`.
FLUX_TRANSFORMER_CONFIG = dict(
    in_channels=64, num_layers=19, num_single_layers=38, num_attention_heads=24,
    attention_head_dim=128, pooled_projection_dim=768, joint_attention_dim=4096,
    guidance_embeds=True,
)
# Flux's latent statistics: z = (z - shift) * scaling (JAX :112-113, :192).
SCALING_FACTOR = 0.3611
SHIFT_FACTOR = 0.1159


class FluxModelSpecification(ModelSpecification):
    transformer_class_name = "FluxTransformer2DModel"
    # JAX :161, pipeline.py:43
    serving_tower_failure = ("serving encodes the T5 slot with that encoder too, whose CLIP-L states (768 wide) reach "
                             "a context embedder that takes 4096")

    @staticmethod
    def transformer_key_map(flax_key: str) -> str:
        """The JAX package's flat parameter name -> this module's (an adapter
        saved with flax names loads through it)."""
        from .weights import flux_key_map

        return flux_key_map(flax_key)

    def __init__(
        self,
        pretrained_model_name_or_path: str = "black-forest-labs/FLUX.1-dev",
        transformer_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[AutoencoderConfig] = None,
        caption_dropout_p: float = 0.0,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        **kwargs,
    ) -> None:
        super().__init__(pretrained_model_name_or_path=pretrained_model_name_or_path, **kwargs)
        self.transformer_config = {**FLUX_TRANSFORMER_CONFIG, **(transformer_config or {})}
        self.vae_autoencoder_config = vae_config or SD_VAE_CONFIG
        self.caption_dropout_p = caption_dropout_p
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.condition_model_processors = [
            CaptionTextDropoutProcessor(caption_dropout_p),
            CLIPPooledProcessor(["pooled_projections"]),
            T5Processor(["encoder_hidden_states", "encoder_attention_mask"],
                        input_names={"text_encoder_2": "text_encoder"}),
        ]

    # ------------------------------------------------------------------ loading
    def _offline_text_encoder(self) -> HashEncoder:
        return HashEncoder(hidden_size=self.transformer_config["joint_attention_dim"], max_length=512,
                           pooled_dim=self.transformer_config["pooled_projection_dim"])

    def load_condition_models(self) -> Dict[str, Any]:
        """CLIP-L pooled (`text_encoder`) and T5-XXL (`text_encoder_2`) from
        their local directories, each in its slot's dtype, else the offline
        hash encoder in the slot, as JAX falls back (:74-103)."""
        from ..text_encoders import CLIPTextHandle, T5Handle

        text_encoder = self._load_text_tower(CLIPTextHandle, self.text_encoder_id, "text_encoder",
                                             self._offline_text_encoder, tokenizer_id=self.tokenizer_id,
                                             dtype=self.text_encoder_dtype)
        text_encoder_2 = self._load_text_tower(T5Handle, self.text_encoder_2_id, "text_encoder_2",
                                               self._offline_text_encoder, tokenizer_id=self.tokenizer_2_id,
                                               dtype=self.text_encoder_2_dtype)
        return {"tokenizer": getattr(text_encoder, "tokenizer", None),
                "tokenizer_2": getattr(text_encoder_2, "tokenizer", None),
                "text_encoder": text_encoder, "text_encoder_2": text_encoder_2}

    def load_latent_models(self) -> Dict[str, Any]:
        """The 2D AutoencoderKL from `vae/`, else the generic VAE (JAX :105-118)."""
        handle = self._load_image_vae(default_scaling=SCALING_FACTOR, default_shift=SHIFT_FACTOR)
        if handle is not None:
            return {"vae": handle}
        vae = generic_vae(self, self.vae_autoencoder_config)
        vae.config.update(scaling_factor=SCALING_FACTOR, shift_factor=SHIFT_FACTOR)
        return {"vae": vae}

    def load_diffusion_models(self) -> Dict[str, Any]:
        """The transformer, random from the spec's generator, its base weights then
        loaded from a local `transformer/` where there is one (JAX :120-141)."""
        with torch.device(self.device):
            module = FluxTransformer2DModel(
                **self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                dtype=self.transformer_dtype, gradient_checkpointing=self.gradient_checkpointing,
            )
        init_parameters_(module, self.generator())
        self._maybe_load_pretrained_transformer(module)
        return {
            "transformer": ModelHandle(module.eval(), dict(self.transformer_config)),
            "scheduler": FlowMatchEulerScheduler(use_dynamic_shifting=True),
        }

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None,
                      text_encoder=None, **kwargs):
        from .pipeline import FluxPipeline

        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        if vae is None:
            vae = self.load_latent_models()["vae"]
        if text_encoder is None:
            text_encoder = self.load_condition_models()["text_encoder"]
        return FluxPipeline(spec=self, transformer=transformer, vae=vae, text_encoder=text_encoder,
                            scheduler=load_scheduler(self.pretrained_model_name_or_path,
                                                     default=FlowMatchEulerScheduler()))

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, text_encoder=None, text_encoder_2=None,
                           max_sequence_length: int = 512, **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, L, C), encoder_attention_mask
        (1, L), pooled_projections (1, P)}; the T5 slot takes `text_encoder`
        where `text_encoder_2` is None (JAX :158-169)."""
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
        """An image (C, H, W) in [-1, 1], or a video's first frame, -> {"latents":
        the VAE's moments (1, 2C, H', W'), fp32 on the VAE's device} (JAX :171-181)."""
        if compute_posterior:
            raise NotImplementedError("the port precomputes VAE moments only (compute_posterior=False)")
        if image is None:
            image = video[0]
        device = next(vae.module.parameters()).device
        x = torch.as_tensor(np.asarray(image, np.float32), device=device)[None]
        return {"latents": encode_image_vae(vae, x)}

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
        """Flow-matching training forward (JAX :183-222) -> (pred, target, sigmas):
        the moments (B, 2C, H, W) sampled, Flux's scaling, the noisy latents
        packed into 2x2 tokens, the model with timestep sigmas * 1000 and
        guidance `guidance` * 1000, the prediction unpacked. The draws
        "posterior" and "noise" (standard normal, the latents' shape) come from
        `draws` where given, else from `generator`."""
        draws = draws or {}
        device = sigmas.device

        def draw(name, shape):
            value = draws.get(name)
            if value is None:
                return torch.randn(shape, generator=generator, device=device)
            return torch.as_tensor(value).to(device).float().reshape(shape)

        moments = latent_model_conditions["latents"].to(device).float()
        b, c2, h, w = moments.shape
        latents = sample_from_moments(moments, noise=draw("posterior", (b, c2 // 2, h, w)))
        latents = (latents - SHIFT_FACTOR) * SCALING_FACTOR
        noise = draw("noise", latents.shape)
        noisy = flow_match_xt(latents, noise, sigmas.reshape(-1, 1, 1, 1))
        ehs = condition_model_conditions["encoder_hidden_states"].to(device)
        pred = transformer.module(
            pack_flux_latents(noisy).to(self.transformer_dtype), ehs,
            condition_model_conditions["pooled_projections"].to(device), sigmas * 1000.0,
            prepare_latent_image_ids(h, w, device), torch.zeros((ehs.shape[1], 3), device=device),
            guidance=torch.full((b,), guidance * 1000.0, dtype=torch.float32, device=device)
            if self.transformer_config["guidance_embeds"] else None,
        )
        return unpack_flux_latents(pred, h, w), flow_match_target(noise, latents), sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, height: int = 1024, width: int = 1024,
                   num_inference_steps: int = 28, **kwargs) -> List[Any]:
        from ...data import ImageArtifact

        image = pipeline(prompt=prompt, height=height, width=width, num_inference_steps=num_inference_steps)
        return [ImageArtifact(value=image)]

    @property
    def _resolution_dim_keys(self) -> Dict[str, Tuple[int, ...]]:
        return {"latents": (2, 3)}
