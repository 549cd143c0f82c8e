"""CogView4 control specification: channel-concat control conditioning for
images (port of `finetrainers_tpu/models/cogview4/control_specification.py`).

The patch embed `patch_embed.proj` is the injection layer: `load_diffusion_models`
builds it for the widened channel count (2x the latent channels, the control
latents' beside the latents'). `prepare_latents` adds the control image's VAE
moments, encoded as one frame through `encode_media` (:64-78); `forward` joins
their posterior mean to the noisy latents on the channel axis (:80-112).
As in JAX, no pretrained transformer is loaded here (the base spec's load
refuses a local checkpoint; ROADMAP.md section 3)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...functional.diffusion import flow_match_target, flow_match_xt
from ...schedulers import FlowMatchEulerScheduler
from ..autoencoders import encode_media, sample_from_moments
from ..modeling_utils import ControlModelSpecification, ModelHandle
from .base_specification import CogView4ModelSpecification
from .weights import _RENAMES


class CogView4ControlModelSpecification(ControlModelSpecification, CogView4ModelSpecification):
    flax_renames = _RENAMES

    @property
    def control_injection_layer_name(self) -> str:
        return "patch_embed.proj"

    @property
    def _original_control_layer_in_features(self) -> int:
        cfg = self.transformer_config
        return cfg["in_channels"] * cfg["patch_size"] ** 2

    @property
    def _original_control_layer_out_features(self) -> int:
        return self.transformer_config["num_attention_heads"] * self.transformer_config["attention_head_dim"]

    @property
    def _qk_norm_identifiers(self) -> List[str]:
        return [r"attn1\.norm_q", r"attn1\.norm_k"]

    def load_diffusion_models(self, new_in_features: Optional[int] = None) -> Dict[str, Any]:
        """The transformer with `new_in_features` input channels (the base
        count where None) and flow-match Euler (JAX :43-62)."""
        config = dict(self.transformer_config)
        if new_in_features is not None:
            config["in_channels"] = new_in_features
        return {"transformer": self._build_transformer(config), "scheduler": FlowMatchEulerScheduler()}

    # ------------------------------------------------------------- data prep
    def prepare_latents(self, vae: ModelHandle, image=None, video=None, control_image=None, control_video=None,
                        compute_posterior: bool = False, **kwargs) -> Dict[str, Any]:
        """The base spec's latents and microconditioning, and "control_latents":
        the control image's (or the control video's first frame's) VAE moments
        (1, 2C, H', W') through `encode_media` as one frame (JAX :64-78)."""
        out = CogView4ModelSpecification.prepare_latents(self, vae, image=image, video=video,
                                                         compute_posterior=compute_posterior)
        if control_image is None and control_video is not None:
            control_image = np.asarray(control_video)[0]
        if control_image is not None:
            device = next(vae.module.parameters()).device
            x = torch.as_tensor(np.asarray(control_image, np.float32), device=device)[None, :, None]
            out["control_latents"] = encode_media(vae, x)[:, :, 0]
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
        """The base forward with the control latents' posterior mean (not a
        sample) joined to the noisy latents on the channel axis (JAX :80-112).
        Draws: "posterior" and "noise", as the base spec's."""
        if "control_latents" not in latent_model_conditions:
            raise ValueError("the control forward needs control_latents: a sample without a control image "
                             "(--control_type none and no control_image column)")
        device = sigmas.device
        draw = self._draw(draws or {}, generator, device)
        moments = latent_model_conditions["latents"].to(device).float()
        b, c2, h, w = moments.shape
        latents = sample_from_moments(moments, noise=draw("posterior", (b, c2 // 2, h, w)))
        control = latent_model_conditions["control_latents"].to(device).float().chunk(2, dim=1)[0]
        noise = draw("noise", latents.shape)
        noisy = flow_match_xt(latents, noise, sigmas.reshape(-1, 1, 1, 1))
        model_in = torch.cat([noisy, control], dim=1)
        pred = self._model_forward(transformer, model_in, condition_model_conditions, latent_model_conditions,
                                   sigmas)
        return pred, flow_match_target(noise, latents), sigmas

    # ------------------------------------------------------------- validation
    def validation(self, pipeline, prompt: str, control_image=None, control_video=None, height: int = 1024,
                   width: int = 1024, num_inference_steps: int = 50, **kwargs) -> List[Any]:
        """Control-conditioned sampling: the pipeline joins the control image's
        posterior mean to the latents in every denoise step (JAX :115-133)."""
        from ...data import ImageArtifact

        if control_image is None and control_video is not None:
            control_image = np.asarray(control_video)[0]
        image = pipeline(prompt=prompt, control_image=control_image, height=height, width=width,
                         num_inference_steps=num_inference_steps)
        return [ImageArtifact(value=image)]
