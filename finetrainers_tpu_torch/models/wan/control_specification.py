"""Wan control specification: channel-concat control conditioning (port of
`finetrainers_tpu/models/wan/control_specification.py`).

The patch embedding is the injection layer: `load_diffusion_models` builds it
for the widened channel count. `prepare_latents` adds the control video's VAE
moments (:86-100); `forward` normalises them with the latent statistics as
the latents' (both halves, the Wan quirk of ROADMAP.md section 3 finding 13),
takes their posterior mean, masks its frames by the frame-conditioning type
and joins it to the noisy latents on the channel axis (:103-136). The
frame-conditioning settings default to JAX's spec defaults (`full`, index 0,
no mask); the control trainer sets them from its flags, and the inference
runner, which has no flag for the type, serves with `full` (ROADMAP.md
section 3). As in JAX, no pretrained transformer is loaded here."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...schedulers import FlowMatchEulerScheduler
from ...trainer.control_trainer.data import apply_frame_conditioning_on_latents_torch
from ..autoencoders import encode_media, sample_from_moments
from ..modeling_utils import ControlModelSpecification, ModelHandle
from .base_specification import WanModelSpecification


class WanControlModelSpecification(ControlModelSpecification, WanModelSpecification):
    def __init__(self, *args, frame_conditioning_type: str = "full", frame_conditioning_index: int = 0,
                 frame_conditioning_concatenate_mask: bool = False, **kwargs) -> None:
        WanModelSpecification.__init__(self, *args, **kwargs)
        self.frame_conditioning_type = frame_conditioning_type
        self.frame_conditioning_index = frame_conditioning_index
        self.frame_conditioning_concatenate_mask = frame_conditioning_concatenate_mask

    @property
    def control_injection_layer_name(self) -> str:
        return "patch_embedding"

    @property
    def _original_control_layer_in_features(self) -> int:
        cfg = self.transformer_config
        pt, ph, pw = cfg["patch_size"]
        return cfg["in_channels"] * pt * ph * pw

    @property
    def _original_control_layer_out_features(self) -> int:
        return self.transformer_config["num_attention_heads"] * self.transformer_config["attention_head_dim"]

    @property
    def _qk_norm_identifiers(self) -> List[str]:
        return [r"attn1\.norm_q", r"attn1\.norm_k", r"attn2\.norm_q", r"attn2\.norm_k"]

    def load_diffusion_models(self, new_in_features: Optional[int] = None) -> Dict[str, Any]:
        """The transformer with `new_in_features` input channels (the base
        count where None) and flow-match Euler with shift 3 (JAX :59-77)."""
        config = dict(self.transformer_config)
        if new_in_features is not None:
            config["in_channels"] = new_in_features
        return {"transformer": self._build_transformer(config), "scheduler": FlowMatchEulerScheduler(shift=3.0)}

    # ------------------------------------------------------------- data prep
    def prepare_latents(self, vae: ModelHandle, image=None, video=None, control_image=None, control_video=None,
                        compute_posterior: bool = False, **kwargs) -> Dict[str, Any]:
        """The base spec's latents, and "control_latents": the control video's
        (or a control image's, as one frame) VAE moments (1, 2C, F', H', W')
        through `encode_media` (JAX :86-100)."""
        out = WanModelSpecification.prepare_latents(self, vae, image=image, video=video,
                                                    compute_posterior=compute_posterior, **kwargs)
        if control_video is None and control_image is not None:
            control_video = np.asarray(control_image)[None]
        if control_video is not None:
            device = next(vae.module.parameters()).device
            x = torch.as_tensor(np.asarray(control_video, np.float32), device=device)[None].permute(0, 2, 1, 3, 4)
            out["control_latents"] = encode_media(vae, x.contiguous())
        return out

    def control_channels(self, control_moments: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Control moments -> the channels joined to the latents: normalised
        as the latents' moments, their posterior mean, the frames masked by the
        spec's frame-conditioning type (and the mask joined where set)."""
        control = self._normalize_moments(control_moments, mean, std).chunk(2, dim=1)[0]
        return apply_frame_conditioning_on_latents_torch(
            control, frame_dim=2, channel_dim=1, frame_conditioning_type=self.frame_conditioning_type,
            frame_conditioning_index=self.frame_conditioning_index,
            concatenate_mask=self.frame_conditioning_concatenate_mask, generator=generator, draws=draws)

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
        """Flow-matching training forward with the control channels (JAX
        :103-136) -> (pred, target, sigmas). Draws: "posterior" and "noise"
        (standard normal, the latents' shape), and for the `prefix` and
        `random` types "frame_keep" and "frame_scores"; each from `draws`
        where given, else from `generator`."""
        if "control_latents" not in latent_model_conditions:
            raise ValueError("the control forward needs control_latents: a sample without a control video "
                             "(--control_type none needs a control_video column in the dataset)")
        draws = draws or {}
        device = sigmas.device

        def draw(name, shape):
            value = draws.get(name)
            if value is None:
                return torch.randn(shape, generator=generator, device=device)
            return torch.as_tensor(value).to(device).float().reshape(shape)

        mean = torch.as_tensor(latent_model_conditions["latents_mean"]).to(device)
        std = torch.as_tensor(latent_model_conditions["latents_std"]).to(device)
        moments = self._normalize_moments(latent_model_conditions["latents"].to(device), mean, std)
        shape = (moments.shape[0], moments.shape[1] // 2, *moments.shape[2:])
        latents = sample_from_moments(moments, noise=draw("posterior", shape))
        control = self.control_channels(latent_model_conditions["control_latents"].to(device), mean, std,
                                        generator=generator, draws=draws)
        noise = draw("noise", latents.shape)
        noisy = flow_match_xt(latents, noise, sigmas.reshape(-1, 1, 1, 1, 1))
        mask = condition_model_conditions.get("encoder_attention_mask")
        pred = transformer.module(
            torch.cat([noisy, control], dim=1).to(self.transformer_dtype),
            condition_model_conditions["encoder_hidden_states"].to(device), sigmas * 1000.0,
            encoder_attention_mask=None if mask is None else mask.to(device),
        )
        return pred, flow_match_target(noise, latents), sigmas

    # ------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, control_image=None, control_video=None, height: int = 480,
                   width: int = 832, num_frames: int = 81, num_inference_steps: int = 50, **kwargs) -> list:
        """Control-conditioned sampling: the pipeline joins the control
        video's channels to the latents in every denoise step (JAX :139-153)."""
        from ...data import VideoArtifact

        video = pipeline(prompt=prompt, control_image=control_image, control_video=control_video, height=height,
                         width=width, num_frames=num_frames, num_inference_steps=num_inference_steps)
        return [VideoArtifact(value=video)]
