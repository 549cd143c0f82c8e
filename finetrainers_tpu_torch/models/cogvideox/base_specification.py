"""CogVideoX model specification, text-to-video: serving and the training
forward (port of `finetrainers_tpu/models/cogvideox/base_specification.py`),
the only family whose objective is not flow matching.

Each component loads from a local diffusers directory, as in JAX: T5 from
`text_encoder/` (`T5Handle`, :74-87), else the offline `HashEncoder(4096,
max_length=226)`; the faithful `AutoencoderKLCogVideoX` from `vae/` (its
config's scaling factor, 1.15258426 without one, on the handle; :89-110),
else the generic `AutoencoderKL3D` with `COGVIDEOX_VAE_CONFIG` at random;
the transformer's base weights from `transformer/` by name (:112-131), else
random. Training and serving scale the latents by 0.7 whichever VAE is loaded,
as JAX does (:66, :185; pipeline.py:83). It serves with its own
`CogVideoXDDIMScheduler` (:72; JAX reads no scheduler config for it).

Training (:168-211): DDIM noising at t = int(sigma * 1000), the model
predicts velocity, pred = sqrt(a) x_t - sqrt(1 - a) v (the x0 estimate),
target = the latents; the trainer weights the loss by 1 / (1 - a).
Latents are frames-first: (B, F, C, H, W), the moments (B, F, 2C, H, W).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...logging import get_logger
from ...processors import CaptionTextDropoutProcessor, T5Processor
from ...schedulers import CogVideoXDDIMScheduler
from ..autoencoders import COGVIDEOX_VAE_CONFIG, AutoencoderConfig, encode_media, generic_vae, media_to_vae_input
from ..layers import init_parameters_
from ..modeling_utils import ModelHandle, ModelSpecification
from .transformer import CogVideoXTransformer3DModel


logger = get_logger(__name__)

# Copied from `finetrainers_tpu/models/cogvideox/base_specification.py:28-37`.
COGVIDEOX_5B_CONFIG = dict(
    in_channels=16, out_channels=16, patch_size=2, num_attention_heads=48,
    attention_head_dim=64, num_layers=42, text_embed_dim=4096, time_embed_dim=512,
    use_rotary_positional_embeddings=True, use_learned_positional_embeddings=False,
)
COGVIDEOX_2B_CONFIG = dict(
    in_channels=16, out_channels=16, patch_size=2, num_attention_heads=30,
    attention_head_dim=64, num_layers=30, text_embed_dim=4096, time_embed_dim=512,
    use_rotary_positional_embeddings=False, use_learned_positional_embeddings=True,
)
SCALING_FACTOR = 0.7  # the value JAX trains and serves with (:63)
MAX_SEQUENCE_LENGTH = 226


class CogVideoXModelSpecification(ModelSpecification):
    transformer_class_name = "CogVideoXTransformer3DModel"

    @staticmethod
    def transformer_key_map(flax_key: str) -> str:
        """The JAX package's flat parameter name -> this module's (an adapter
        saved with flax names loads through it)."""
        from .weights import cogvideox_key_map

        return cogvideox_key_map(flax_key)

    def __init__(
        self,
        pretrained_model_name_or_path: str = "THUDM/CogVideoX-5b",
        transformer_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[AutoencoderConfig] = None,
        caption_dropout_p: float = 0.0,
        lora_rank: int = 0,
        lora_alpha: float = 1.0,
        **kwargs,
    ) -> None:
        super().__init__(pretrained_model_name_or_path=pretrained_model_name_or_path, **kwargs)
        self.transformer_config = {**COGVIDEOX_5B_CONFIG, **(transformer_config or {})}
        self.vae_autoencoder_config = vae_config or COGVIDEOX_VAE_CONFIG
        self.caption_dropout_p = caption_dropout_p
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.vae_scaling_factor = SCALING_FACTOR
        self.condition_model_processors = [
            CaptionTextDropoutProcessor(caption_dropout_p),
            T5Processor(["encoder_hidden_states", "encoder_attention_mask"]),
        ]
        self._scheduler = CogVideoXDDIMScheduler()

    # ------------------------------------------------------------------ loading
    def load_condition_models(self) -> Dict[str, Any]:
        """T5 from a local directory, else the offline hash encoder (JAX :74-87)."""
        encoder = self._load_t5(self.transformer_config["text_embed_dim"], max_length=MAX_SEQUENCE_LENGTH)
        return {"tokenizer": getattr(encoder, "tokenizer", None), "text_encoder": encoder}

    def load_latent_models(self) -> Dict[str, Any]:
        """The faithful `AutoencoderKLCogVideoX` from `vae/`, else the generic VAE (JAX :89-110)."""
        from .vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig

        handle = self._load_video_vae(AutoencoderKLCogVideoX, CogVideoXVAEConfig, default_scaling=1.15258426)
        if handle is not None:
            return {"vae": handle}
        vae = generic_vae(self, self.vae_autoencoder_config)
        vae.config["scaling_factor"] = SCALING_FACTOR
        return {"vae": vae}

    def load_diffusion_models(self) -> Dict[str, Any]:
        """The transformer, random from the spec's generator, its base weights then
        loaded from a local `transformer/` where there is one (JAX :112-131)."""
        with torch.device(self.device):
            module = CogVideoXTransformer3DModel(
                **self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                dtype=self.transformer_dtype, gradient_checkpointing=self.gradient_checkpointing,
            )
        init_parameters_(module, self.generator())
        self._maybe_load_pretrained_transformer(module)
        return {"transformer": ModelHandle(module.eval(), dict(self.transformer_config)),
                "scheduler": self._scheduler}

    def load_pipeline(self, transformer: ModelHandle = None, vae: ModelHandle = None,
                      text_encoder=None, **kwargs):
        from .pipeline import CogVideoXPipeline

        if transformer is None:
            transformer = self.load_diffusion_models()["transformer"]
        if vae is None:
            vae = self.load_latent_models()["vae"]
        if text_encoder is None:
            text_encoder = self.load_condition_models()["text_encoder"]
        return CogVideoXPipeline(spec=self, transformer=transformer, vae=vae, text_encoder=text_encoder,
                                 scheduler=self._scheduler)

    # ------------------------------------------------------------- data prep
    def prepare_conditions(self, caption: str, text_encoder=None, max_sequence_length: int = MAX_SEQUENCE_LENGTH,
                           **kwargs) -> Dict[str, Any]:
        """caption -> numpy {encoder_hidden_states (1, 226, 4096), masked;
        encoder_attention_mask (1, 226)} (JAX :136-145)."""
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
        """An image (C, H, W) or a video (T, C, H, W) in [-1, 1] -> {"latents":
        the VAE's moments turned frames-first, (1, F', 2C, H', W'), fp32 on the
        VAE's device} (JAX :147-156)."""
        if compute_posterior:
            raise NotImplementedError("the port precomputes VAE moments only (compute_posterior=False)")
        device = next(vae.module.parameters()).device
        moments = encode_media(vae, media_to_vae_input(image, video, device))
        return {"latents": moments.permute(0, 2, 1, 3, 4).contiguous()}

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
        """DDIM training forward (JAX :159-211) -> (pred, target, sigmas): the
        frames-first moments split on dim 2 and sampled (log-variance clipped
        to [-30, 20]), scaled by 0.7, frames padded by repeating the last one
        to a multiple of `patch_size_t`, noised at t = int(sigma * 1000), the
        model at timestep t; pred = sqrt(a) x_t - sqrt(1 - a) v, target = the
        latents. The draws "posterior" and "noise" (standard normal, the
        latents' shape) come from `draws` where given, else from `generator`."""
        draws = draws or {}
        device = sigmas.device
        scheduler = self._scheduler

        def draw(name, shape):
            value = draws.get(name)
            if value is None:
                return torch.randn(shape, generator=generator, device=device)
            return torch.as_tensor(value).to(device).float().reshape(shape)

        moments = latent_model_conditions["latents"].to(device).float()
        mean, logvar = moments.chunk(2, dim=2)
        logvar = logvar.clamp(-30.0, 20.0)
        latents = (mean + torch.exp(0.5 * logvar) * draw("posterior", mean.shape)) * self.vae_scaling_factor
        pt = self.transformer_config.get("patch_size_t") or 1
        if pt > 1 and latents.shape[1] % pt != 0:
            extra = pt - latents.shape[1] % pt
            latents = torch.cat([latents, latents[:, -1:].expand(-1, extra, -1, -1, -1)], dim=1)

        timesteps = scheduler.timesteps(sigmas)
        noisy = scheduler.add_noise(latents, draw("noise", latents.shape), timesteps)
        velocity = transformer.module(noisy.to(self.transformer_dtype),
                                      condition_model_conditions["encoder_hidden_states"].to(device),
                                      timesteps.float())
        a = scheduler.alphas_cumprod.to(device)[timesteps].reshape(-1, 1, 1, 1, 1)
        pred = torch.sqrt(a) * noisy - torch.sqrt(1.0 - a) * velocity.float()
        return pred, latents, sigmas

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, height: int = 480, width: int = 720, num_frames: int = 49,
                   num_inference_steps: int = 50, **kwargs) -> List[Any]:
        from ...data import VideoArtifact

        video = pipeline(prompt=prompt, height=height, width=width, num_frames=num_frames,
                         num_inference_steps=num_inference_steps)
        return [VideoArtifact(value=video)]

    # ------------------------------------------------------------- parallelism
    def cp_plan(self) -> Dict[str, int]:
        """The dim a context-parallel split cuts: the frames (JAX :230-231)."""
        return {"latents": 1}

    @property
    def _resolution_dim_keys(self) -> Dict[str, Tuple[int, ...]]:
        return {"latents": (1, 3, 4)}
