"""LTX-Video model specification, serving part (port of
`finetrainers_tpu/models/ltx_video/base_specification.py`).

Random weights only: neither a T5 nor an LTX VAE checkpoint exists for the
port yet, so it serves with the same offline components the JAX package falls
back to — `HashEncoder` for text and the generic `AutoencoderKL3D` with
`LTX_VAE_CONFIG`. A local checkpoint directory for any component raises
NotImplementedError instead of being ignored. The training `forward` comes
with the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...logging import get_logger
from ...processors import CaptionTextDropoutProcessor, HashEncoder, T5Processor
from ...schedulers import FlowMatchEulerScheduler, load_scheduler
from ..autoencoders import LTX_VAE_CONFIG, AutoencoderConfig, AutoencoderKL3D
from ..layers import init_parameters_
from ..modeling_utils import ModelHandle, ModelSpecification
from .transformer import LTXVideoTransformer3DModel


logger = get_logger(__name__)

LTX_TRANSFORMER_CONFIG = dict(
    in_channels=128, out_channels=128, patch_size=1, patch_size_t=1,
    num_attention_heads=32, attention_head_dim=64, cross_attention_dim=2048,
    num_layers=28, caption_channels=4096,
)


class LTXVideoModelSpecification(ModelSpecification):
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
    def _refuse_checkpoint(self, explicit_id: Optional[str], subfolder: str, what: str) -> None:
        path = self._component_dir(explicit_id, subfolder)
        if path is not None:
            raise NotImplementedError(f"loading {what} from {path} is not ported yet; see ROADMAP.md")

    def load_condition_models(self) -> Dict[str, Any]:
        self._refuse_checkpoint(self.text_encoder_id, "text_encoder", "the T5 text encoder")
        logger.warning("T5 is not ported; using the offline hash encoder")
        encoder = HashEncoder(hidden_size=self.transformer_config["caption_channels"], max_length=128)
        return {"tokenizer": None, "text_encoder": encoder}

    def load_latent_models(self) -> Dict[str, Any]:
        self._refuse_checkpoint(self.vae_id, "vae", "the LTX VAE")
        with torch.device(self.device):
            module = AutoencoderKL3D(self.vae_autoencoder_config, dtype=self.vae_dtype)
        init_parameters_(module, self.generator()).eval()
        latent_ch = self.vae_autoencoder_config.latent_channels
        config = {
            "latent_channels": latent_ch,
            "spatial_compression_ratio": self.vae_autoencoder_config.spatial_compression_ratio,
            "temporal_compression_ratio": self.vae_autoencoder_config.temporal_compression_ratio,
            # Per-channel stats (real values come with a checkpoint; identity here).
            "latents_mean": np.zeros((latent_ch,), np.float32),
            "latents_std": np.ones((latent_ch,), np.float32),
        }
        return {"vae": ModelHandle(module, config)}

    def load_diffusion_models(self) -> Dict[str, Any]:
        self._refuse_checkpoint(self.transformer_id, "transformer", "transformer weights")
        with torch.device(self.device):
            module = LTXVideoTransformer3DModel(
                **self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                dtype=self.transformer_dtype,
            )
        init_parameters_(module, self.generator()).eval()
        return {
            "transformer": ModelHandle(module, dict(self.transformer_config)),
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
