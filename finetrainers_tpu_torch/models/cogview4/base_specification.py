"""CogView4 model specification, text-to-image: serving and the training
forward (port of `finetrainers_tpu/models/cogview4/base_specification.py`).

Each component loads from a local diffusers directory where one exists, as
in JAX (:65-106): the GLM-4 tower from `text_encoder/` (`GlmHandle`, in
`text_encoder_dtype`, with `tokenizer_id`'s tokenizer where transformers
has one), the 2D `AutoencoderKL` from `vae/` (scaling and shift from its
config) and the transformer's base weights from `transformer/` (the LoRA
factors stay fresh; `transformer_config` must match the checkpoint). Without
them it runs with the offline components the JAX package falls back to:
`HashEncoder(4096, max_length=128)`, whose states `prepare_conditions` pads
to 1024 slots (:124; all of them reach the joint attention, ROADMAP.md
section 3), the generic `AutoencoderKL3D` with `SD_VAE_CONFIG` on single
frames with latent scaling 1.0, and random transformer weights; flow-match
Euler (:99) unless the checkpoint directory's scheduler config names another.
The control spec builds its widened transformer without a checkpoint and
refuses a local one (ROADMAP.md section 3, finding 19).
`prepare_latents` gives the image's VAE moments with SDXL's size and crop
microconditioning (:128-146), and `forward` trains on them (:149-177).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...logging import get_logger
from ...processors import CaptionTextDropoutProcessor, CogView4GLMProcessor, HashEncoder
from ...schedulers import FlowMatchEulerScheduler, load_scheduler
from ..autoencoders import SD_VAE_CONFIG, AutoencoderConfig, encode_image_vae, generic_vae, sample_from_moments
from ..layers import init_parameters_
from ..modeling_utils import ModelHandle, ModelSpecification
from .transformer import CogView4Transformer2DModel


logger = get_logger(__name__)

# Copied from `finetrainers_tpu/models/cogview4/base_specification.py:28-31`.
COGVIEW4_TRANSFORMER_CONFIG = dict(
    in_channels=16, out_channels=16, patch_size=2, num_attention_heads=32,
    attention_head_dim=128, num_layers=28, text_embed_dim=4096, time_embed_dim=512,
)


class CogView4ModelSpecification(ModelSpecification):
    transformer_class_name = "CogView4Transformer2DModel"

    @staticmethod
    def transformer_key_map(flax_key: str) -> str:
        """The JAX package's flat parameter name -> this module's (an adapter
        saved with flax names loads through it)."""
        from .weights import cogview4_key_map

        return cogview4_key_map(flax_key)

    def __init__(
        self,
        pretrained_model_name_or_path: str = "THUDM/CogView4-6B",
        transformer_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[AutoencoderConfig] = None,
        caption_dropout_p: float = 0.0,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        **kwargs,
    ) -> None:
        super().__init__(pretrained_model_name_or_path=pretrained_model_name_or_path, **kwargs)
        self.transformer_config = {**COGVIEW4_TRANSFORMER_CONFIG, **(transformer_config or {})}
        self.vae_autoencoder_config = vae_config or SD_VAE_CONFIG
        self.caption_dropout_p = caption_dropout_p
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.condition_model_processors = [
            CaptionTextDropoutProcessor(caption_dropout_p),
            CogView4GLMProcessor(["encoder_hidden_states"]),
        ]

    # ------------------------------------------------------------------ loading
    def load_condition_models(self) -> Dict[str, Any]:
        """GLM-4 from `text_encoder/`, else the offline hash encoder (JAX :65-73)."""
        from ..text_encoders import GlmHandle

        encoder = self._load_text_tower(
            GlmHandle, self.text_encoder_id, "text_encoder",
            lambda: HashEncoder(hidden_size=self.transformer_config["text_embed_dim"], max_length=128),
            tokenizer_id=self.tokenizer_id, dtype=self.text_encoder_dtype,
        )
        return {"tokenizer": getattr(encoder, "tokenizer", None), "text_encoder": encoder}

    def load_latent_models(self) -> Dict[str, Any]:
        """The 2D AutoencoderKL from `vae/`, else the generic VAE (JAX :75-86)."""
        handle = self._load_image_vae(default_scaling=1.0)
        if handle is not None:
            return {"vae": handle}
        return {"vae": generic_vae(self, self.vae_autoencoder_config)}

    def _build_transformer(self, config: Dict[str, Any], pretrained: bool = False) -> ModelHandle:
        """The transformer at `config`, random from the spec's generator; with
        `pretrained` its base weights then load from a local `transformer/`
        (JAX :88-106), else a local one raises (the control spec's widened
        model, ROADMAP.md section 3 finding 19)."""
        if not pretrained:
            self._refuse_checkpoint(self.transformer_id, "transformer", "a control model's transformer weights "
                                    "(ROADMAP.md section 3 finding 19, queue 1 item 5)")
        with torch.device(self.device):
            module = CogView4Transformer2DModel(
                **config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha, dtype=self.transformer_dtype,
                gradient_checkpointing=self.gradient_checkpointing,
            )
        init_parameters_(module, self.generator())
        if pretrained:
            self._maybe_load_pretrained_transformer(module)
        return ModelHandle(module.eval(), dict(config))

    def load_diffusion_models(self) -> Dict[str, Any]:
        return {"transformer": self._build_transformer(self.transformer_config, pretrained=True),
                "scheduler": FlowMatchEulerScheduler()}

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None,
                      text_encoder=None, **kwargs):
        from .pipeline import CogView4Pipeline

        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        if vae is None:
            vae = self.load_latent_models()["vae"]
        if text_encoder is None:
            text_encoder = self.load_condition_models()["text_encoder"]
        return CogView4Pipeline(spec=self, transformer=transformer, vae=vae, text_encoder=text_encoder,
                                scheduler=load_scheduler(self.pretrained_model_name_or_path,
                                                         default=FlowMatchEulerScheduler()))

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, text_encoder=None, max_sequence_length: int = 1024,
                           **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, 1024, 4096)}: every slot,
        the padded ones too (JAX :124-126)."""
        data = {"caption": caption, "text_encoder": text_encoder, "max_sequence_length": max_sequence_length}
        for processor in self.condition_model_processors:
            data.update(processor(**data))
        return {"encoder_hidden_states": data["encoder_hidden_states"]}

    def prepare_latents(self, vae: ModelHandle, image: Optional[np.ndarray] = None,
                        video: Optional[np.ndarray] = None, compute_posterior: bool = False,
                        **kwargs) -> Dict[str, Any]:
        """An image (C, H, W) in [-1, 1], or a video's first frame, -> {"latents":
        the VAE's moments (1, 2C, H', W'), fp32 on the VAE's device;
        "original_size" and "target_size" [[H, W]], "crop_coords" [[0, 0]],
        fp32 numpy} (JAX :128-146)."""
        if compute_posterior:
            raise NotImplementedError("the port precomputes VAE moments only (compute_posterior=False)")
        if image is None:
            image = video[0]
        _, h, w = np.asarray(image).shape
        device = next(vae.module.parameters()).device
        x = torch.as_tensor(np.asarray(image, np.float32), device=device)[None]
        return {
            "latents": encode_image_vae(vae, x),
            "original_size": np.asarray([[h, w]], np.float32),
            "target_size": np.asarray([[h, w]], np.float32),
            "crop_coords": np.asarray([[0, 0]], np.float32),
        }

    # ---------------------------------------------------------------- training
    @staticmethod
    def _draw(draws: Dict[str, Any], generator: Optional[torch.Generator], device: torch.device):
        """name, shape -> the draw handed in under `name`, else a standard normal from `generator`."""
        def draw(name, shape):
            value = draws.get(name)
            if value is None:
                return torch.randn(shape, generator=generator, device=device)
            return torch.as_tensor(value).to(device).float().reshape(shape)
        return draw

    def _model_forward(self, transformer: ModelHandle, model_in: torch.Tensor, conditions: Dict[str, torch.Tensor],
                       latent_conditions: Dict[str, torch.Tensor], sigmas: torch.Tensor) -> torch.Tensor:
        device = sigmas.device

        def micro(name):
            value = latent_conditions.get(name)
            return None if value is None else torch.as_tensor(value).to(device).float()

        return transformer.module(model_in.to(self.transformer_dtype),
                                  conditions["encoder_hidden_states"].to(device), sigmas * 1000.0,
                                  original_size=micro("original_size"), target_size=micro("target_size"),
                                  crop_coords=micro("crop_coords"))

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
        """Flow-matching training forward (JAX :149-177) -> (pred, target,
        sigmas): the moments (B, 2C, H, W) sampled, noised at sigmas, the model
        with timestep sigmas * 1000 and the sizes and crops. The draws
        "posterior" and "noise" (standard normal, the latents' shape) come from
        `draws` where given, else from `generator`."""
        draw = self._draw(draws or {}, generator, sigmas.device)
        moments = latent_model_conditions["latents"].to(sigmas.device).float()
        b, c2, h, w = moments.shape
        latents = sample_from_moments(moments, noise=draw("posterior", (b, c2 // 2, h, w)))
        noise = draw("noise", latents.shape)
        noisy = flow_match_xt(latents, noise, sigmas.reshape(-1, 1, 1, 1))
        pred = self._model_forward(transformer, noisy, condition_model_conditions, latent_model_conditions, sigmas)
        return pred, flow_match_target(noise, latents), sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, height: int = 1024, width: int = 1024,
                   num_inference_steps: int = 50, **kwargs) -> List[Any]:
        from ...data import ImageArtifact

        image = pipeline(prompt=prompt, height=height, width=width, num_inference_steps=num_inference_steps)
        return [ImageArtifact(value=image)]

    @property
    def _resolution_dim_keys(self) -> Dict[str, Tuple[int, ...]]:
        return {"latents": (2, 3)}
