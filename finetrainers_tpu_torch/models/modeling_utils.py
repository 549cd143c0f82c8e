"""ModelSpecification: the per-model adapter contract (port of the serving
and training-step parts of `finetrainers_tpu/models/modeling_utils.py`).

A component is a `ModelHandle`: an `nn.Module` with its config dict (the JAX
package's handle also carries the parameter tree, which here lives inside the
module). Every spec takes an explicit `device`; its loaders build and
random-initialise their modules there, from `torch.Generator`s seeded with
`seed`, and never on an implicit CPU. Where a family loads a component from
a local checkpoint directory (`_load_text_tower`, `_load_t5`,
`_load_image_vae`, `_load_video_vae`, `_maybe_load_pretrained_transformer`),
the module is built on the device in the spec's dtype and its weights are
copied in by name.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

import torch
import torch.nn as nn

from ..logging import get_logger


logger = get_logger(__name__)


# Keys that collation takes from the first sample instead of stacking.
IGNORE_KEYS_FOR_COLLATION = ["height", "width", "num_frames", "frame_rate", "rope_interpolation_scale"]


@dataclasses.dataclass
class ModelHandle:
    """A model component: module + config dict, with the VAE's memory-bounded
    encode modes (`autoencoders.encode_media`; JAX modeling_utils.py:48-60)."""

    module: nn.Module
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    use_slicing: bool = False
    use_tiling: bool = False

    def enable_slicing(self) -> None:
        self.use_slicing = True

    def enable_tiling(self) -> None:
        self.use_tiling = True


class ModelSpecification:
    """Base class for model specs (reference modeling_utils.py:26-300)."""

    transformer_class_name: Optional[str] = None

    def __init__(
        self,
        pretrained_model_name_or_path: Optional[str] = None,
        text_encoder_id: Optional[str] = None,
        transformer_id: Optional[str] = None,
        vae_id: Optional[str] = None,
        transformer_dtype: torch.dtype = torch.bfloat16,
        vae_dtype: torch.dtype = torch.bfloat16,
        *,
        device: Union[str, torch.device],
        seed: int = 0,
        text_encoder_2_id: Optional[str] = None,
        tokenizer_id: Optional[str] = None,
        tokenizer_2_id: Optional[str] = None,
        text_encoder_dtype: torch.dtype = torch.bfloat16,
        text_encoder_2_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        self.pretrained_model_name_or_path = pretrained_model_name_or_path
        self.text_encoder_id = text_encoder_id
        self.text_encoder_2_id = text_encoder_2_id
        self.tokenizer_id = tokenizer_id
        self.tokenizer_2_id = tokenizer_2_id
        self.text_encoder_dtype = text_encoder_dtype
        self.text_encoder_2_dtype = text_encoder_2_dtype
        self.transformer_id = transformer_id
        self.vae_id = vae_id
        self.transformer_dtype = transformer_dtype
        self.vae_dtype = vae_dtype
        self.device = torch.device(device)
        self.seed = seed
        self.transformer_config: Dict[str, Any] = {}
        # Per-block remat policy (None or a type of CHECKPOINT_TYPES), set by the
        # trainer before load_diffusion_models.
        self.gradient_checkpointing: Optional[str] = None

    def generator(self) -> torch.Generator:
        """A fresh generator on the spec's device, seeded with `seed`."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    # ------------------------------------------------------------------ loading
    def load_condition_models(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_latent_models(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_diffusion_models(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_pipeline(self, **kwargs) -> Any:
        raise NotImplementedError

    # Why serving fails in JAX with a tower loaded in the `text_encoder` slot, for a family whose serving encodes
    # a second slot with that slot's encoder (ROADMAP.md section 3 finding 14); None where serving takes any tower.
    serving_tower_failure: Optional[str] = None

    def check_serving_text_encoders(self) -> None:
        """Raise a ValueError where serving (the runner, a trainer's
        validation) would load a tower into the `text_encoder` slot of a family
        whose serving fails with one there in JAX (`serving_tower_failure`);
        called before any model loads, as finding 16's refusal is."""
        path = self._component_dir(self.text_encoder_id, "text_encoder")
        if self.serving_tower_failure and path is not None:
            raise ValueError(f"{type(self).__name__} serves with the tower of {path} in the text_encoder slot: "
                             f"{self.serving_tower_failure}, so JAX fails and the port refuses it (ROADMAP.md "
                             "section 3 finding 14). Train without --validation_dataset_file, or serve with the "
                             "offline encoder")

    # ------------------------------------------------------------ data prep
    def prepare_conditions(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def prepare_latents(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def collate_conditions(self, data: List[Dict[str, Any]]) -> Dict[str, Any]:
        return _default_collate(data)

    def collate_latents(self, data: List[Dict[str, Any]]) -> Dict[str, Any]:
        return _default_collate(data)

    @property
    def _resolution_dim_keys(self) -> Dict[str, Tuple[int, ...]]:
        """The leader tensor and the dims the resolution sampler buckets by."""
        return {"latents": (2, 3, 4)}

    # ---------------------------------------------------------------- training
    def forward(self, transformer: ModelHandle, condition_model_conditions: Dict[str, torch.Tensor],
                latent_model_conditions: Dict[str, torch.Tensor], sigmas: torch.Tensor, **kwargs):
        """One training forward -> (pred, target, sigmas)."""
        raise NotImplementedError

    # -------------------------------------------------------------- validation
    def validation(self, pipeline, **kwargs) -> List[Any]:
        raise NotImplementedError

    # ------------------------------------------------------------------ export
    def _save_lora_weights(self, directory: str, lora_state, lora_config: Dict[str, Any]) -> None:
        """Write an inference-ready adapter (`lora.save_lora_weights`; JAX
        modeling_utils.py:167-177). The module's parameter names are already
        diffusers' (JAX maps its flax names through the family's key map here)."""
        from ..lora import save_lora_weights

        save_lora_weights(directory, lora_state, lora_config)

    def _save_model(self, directory: str, transformer: ModelHandle) -> None:
        """The transformer in diffusers format: config.json and
        diffusion_pytorch_model.safetensors without the LoRA factors (JAX
        modeling_utils.py:179-200)."""
        from ..lora import LORA_KEYS
        from ..utils.serialization import safetensors_save_dict

        os.makedirs(directory, exist_ok=True)
        state = {name: value for name, value in transformer.module.state_dict().items()
                 if not any(f".{key}." in f".{name}" for key in LORA_KEYS)}
        safetensors_save_dict(state, os.path.join(directory, "diffusion_pytorch_model.safetensors"))
        config = dict(transformer.config or {})
        if self.transformer_class_name:
            config["_class_name"] = self.transformer_class_name
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(config, f, indent=2)

    def _refuse_checkpoint(self, explicit_id: Optional[str], subfolder: str, what: str) -> None:
        """Raise where a local checkpoint of a component exists: loading one is
        not ported yet, and random weights must not stand in for it silently."""
        path = self._component_dir(explicit_id, subfolder)
        if path is not None:
            raise NotImplementedError(f"loading {what} from {path} is not ported yet; see ROADMAP.md")

    def _load_text_tower(self, handle_cls, explicit_id: Optional[str], subfolder: str,
                         fallback_fn: Callable[[], Any], **kwargs):
        """A text tower from a local checkpoint directory (`explicit_id` or
        <pretrained>/<subfolder>), built on the spec's device; where there is
        none, `fallback_fn()` (the offline hash encoder). A directory whose
        files do not load (a missing or malformed config, shards or weights)
        also falls back, with JAX's warning (JAX modeling_utils.py:217-231);
        an error of the device or a kernel is raised."""
        path = self._component_dir(explicit_id, subfolder)
        if path is not None:
            try:
                tower = handle_cls(path, device=self.device, **kwargs)
                logger.info(f"Loaded {handle_cls.__name__} from {path}")
                return tower
            except (OSError, ValueError, KeyError) as e:
                logger.warning(f"Failed to load {handle_cls.__name__} from {path}: {e}; using offline fallback")
        return fallback_fn()

    def _load_image_vae(self, default_scaling: float = 0.18215,
                        default_shift: Optional[float] = None) -> Optional[ModelHandle]:
        """The 2D `AutoencoderKL` from a local diffusers `vae/` directory
        (config.json and its safetensors), built on the spec's device in
        `vae_dtype` and loaded strict by name, with the latent statistics of
        its config; None where no such directory exists (the caller keeps its
        offline VAE). A directory with a config but no weights gives a
        random VAE with a warning, as in JAX (modeling_utils.py:233-270)."""
        vae_dir = self._component_dir(self.vae_id, "vae")
        if vae_dir is None:
            return None
        from .autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
        from .layers import init_parameters_
        from .weight_utils import load_diffusers_checkpoint_dir, load_diffusers_config, load_named_weights

        hf_cfg = load_diffusers_config(vae_dir)
        cfg = AutoencoderKLConfig.from_hf(hf_cfg)
        with torch.device(self.device):
            module = AutoencoderKL(cfg, dtype=self.vae_dtype)
        try:
            state = load_diffusers_checkpoint_dir(vae_dir)
            load_named_weights(module, state)
            logger.info(f"Loaded AutoencoderKL weights from {vae_dir} ({len(state)} tensors)")
        except FileNotFoundError:
            logger.warning(f"{vae_dir} has a config but no weights; using random-init VAE")
            init_parameters_(module, self.generator())
        return ModelHandle(module.eval(), {
            "latent_channels": cfg.latent_channels,
            "spatial_compression_ratio": cfg.spatial_compression_ratio,
            "scaling_factor": hf_cfg.get("scaling_factor", default_scaling),
            "shift_factor": hf_cfg.get("shift_factor", default_shift),
        })

    def _load_video_vae(self, module_cls, config_cls, default_scaling: float = 1.0) -> Optional[ModelHandle]:
        """A family's causal 3D VAE (`AutoencoderKLWan`, `AutoencoderKLLTXVideo`,
        `AutoencoderKLCogVideoX`, `AutoencoderKLHunyuanVideo`) from a local
        diffusers `vae/` directory, built on the spec's device in `vae_dtype`
        and loaded by name (strict on every parameter; entries the module does
        not hold, such as a checkpoint's latent-statistics buffers, are skipped
        as JAX's converter skips them), with `scaling_factor`
        (`default_scaling` without it), `latents_mean` and `latents_std` (zeros
        and ones) from its config; None where no such directory exists (the
        caller keeps its generic VAE). A directory with a config but no weights
        gives a random VAE with a warning, as in JAX (modeling_utils.py:272-316)."""
        vae_dir = self._component_dir(self.vae_id, "vae")
        if vae_dir is None:
            return None
        from .layers import init_parameters_
        from .weight_utils import load_diffusers_checkpoint_dir, load_diffusers_config, load_named_weights

        hf_cfg = load_diffusers_config(vae_dir)
        cfg = config_cls.from_hf(hf_cfg)
        with torch.device(self.device):
            module = module_cls(cfg, dtype=self.vae_dtype)
        try:
            state = load_diffusers_checkpoint_dir(vae_dir)
            skipped = load_named_weights(module, state, ignore_unexpected=True)
            logger.info(f"Loaded {module_cls.__name__} weights from {vae_dir} ({len(state)} tensors"
                        + (f"; {list(skipped)} skipped)" if skipped else ")"))
        except FileNotFoundError:
            logger.warning(f"{vae_dir} has a config but no weights; using random-init VAE")
            init_parameters_(module, self.generator())
        latent_ch = getattr(cfg, "z_dim", None) or getattr(cfg, "latent_channels", None)
        mean, std = hf_cfg.get("latents_mean"), hf_cfg.get("latents_std")
        return ModelHandle(module.eval(), {
            "latent_channels": latent_ch,
            "spatial_compression_ratio": cfg.spatial_compression_ratio,
            "temporal_compression_ratio": cfg.temporal_compression_ratio,
            "scaling_factor": hf_cfg.get("scaling_factor", default_scaling),
            "latents_mean": np.asarray(mean, np.float32) if mean is not None else np.zeros((latent_ch,), np.float32),
            "latents_std": np.asarray(std, np.float32) if std is not None else np.ones((latent_ch,), np.float32),
        })

    def _load_t5(self, hidden_size: int, max_length: int):
        """The T5 or UMT5 tower from `text_encoder_id` or the pretrained path
        (a tower's directory, or a pipeline root holding `text_encoder/`:
        `T5Handle.resolve`), through `_load_text_tower`; else the offline
        `HashEncoder(hidden_size, max_length)`, with a warning (JAX builds
        `FlaxT5Handle(text_encoder_id or pretrained)` and falls back to the
        hash encoder on any failure)."""
        from ..processors import HashEncoder
        from .text_encoders import T5Handle

        def offline():
            logger.warning("No local T5 directory; using the offline hash encoder")
            return HashEncoder(hidden_size=hidden_size, max_length=max_length)

        explicit = T5Handle.resolve(self.text_encoder_id or self.pretrained_model_name_or_path)
        return self._load_text_tower(T5Handle, explicit, "text_encoder", offline,
                                     tokenizer_id=self.tokenizer_id, dtype=self.text_encoder_dtype)

    def _maybe_load_pretrained_transformer(self, module: nn.Module, subfolder: str = "transformer") -> bool:
        """Load a local diffusers transformer directory (`transformer_id` or
        <pretrained>/<subfolder>, holding a config.json or safetensors) into
        `module` by name, strict on every base weight's name and shape; the
        LoRA factors keep their fresh init (JAX modeling_utils.py:318-339).
        Returns whether a directory was loaded; without one the module is left
        as it is (a Hub id would need the network)."""
        from .weight_utils import load_diffusers_checkpoint_dir, load_named_weights

        for candidate in (self.transformer_id, os.path.join(self.pretrained_model_name_or_path or "", subfolder)):
            if candidate and os.path.isdir(candidate) and (
                    os.path.exists(os.path.join(candidate, "config.json"))
                    or any(f.endswith(".safetensors") for f in os.listdir(candidate))):
                state = load_diffusers_checkpoint_dir(candidate)
                logger.info(f"Loading transformer weights from {candidate} ({len(state)} tensors)")
                load_named_weights(module, state)
                return True
        return False

    def _component_dir(self, explicit_id: Optional[str], subfolder: str) -> Optional[str]:
        """Resolve a local HF component directory (explicit id or
        <pretrained_model_name_or_path>/<subfolder>) holding a config.json."""
        for candidate in (
            explicit_id,
            os.path.join(self.pretrained_model_name_or_path or "", subfolder),
        ):
            if candidate and os.path.isdir(candidate) and os.path.exists(os.path.join(candidate, "config.json")):
                return candidate
        return None


class ControlModelSpecification(ModelSpecification):
    """Channel-concat control conditioning (JAX modeling_utils.py:359-386):
    the injection layer (the patch embed) takes the control latents' channels
    beside the latents', and trains at full rank beside the LoRA factors.

    `control_injection_layer_name` and `_qk_norm_identifiers` name the port's
    modules (JAX names its flax ones; the aux file holds JAX's names through
    the family's key map, with `flax_renames` undone). `load_diffusion_models`
    takes the widened channel count; the base count stays in
    `transformer_config` (JAX writes the widened one back, so its reload for
    the final validation widens twice: ROADMAP.md section 3)."""

    # The ordered (flax, port) renames of the family's key map, undone to name
    # the aux file's entries (`weight_utils.torch_key_to_flax`).
    flax_renames: Tuple[Tuple[str, str], ...] = ()

    @property
    def control_injection_layer_name(self) -> str:
        raise NotImplementedError

    @property
    def _original_control_layer_in_features(self) -> int:
        raise NotImplementedError

    @property
    def _original_control_layer_out_features(self) -> int:
        raise NotImplementedError

    @property
    def _qk_norm_identifiers(self) -> List[str]:
        return []

    def load_diffusion_models(self, new_in_features: Optional[int] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def control_lora_rank_pattern(self, rank: int) -> Dict[str, int]:
        """The injection layer trains at full rank (JAX :379-381)."""
        return {self.control_injection_layer_name: self._original_control_layer_out_features}

    def control_lora_alpha_pattern(self, alpha: float) -> Dict[str, float]:
        return {self.control_injection_layer_name: self._original_control_layer_out_features}

def _default_collate(data: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Join the samples' arrays (numpy or tensors) on the batch dim, except
    IGNORE_KEYS_FOR_COLLATION and scalars, which come from the first sample
    (copied from `finetrainers_tpu/models/modeling_utils.py:406-427`): arrays
    with a leading batch dim of 1 are concatenated, others stacked."""
    out: Dict[str, Any] = {}
    for key in (data[0] if data else {}):
        values = [d[key] for d in data]
        first = values[0]
        if key in IGNORE_KEYS_FOR_COLLATION or getattr(first, "ndim", 0) == 0:
            out[key] = first
        elif isinstance(first, torch.Tensor):
            out[key] = torch.cat(values) if first.shape[0] == 1 else torch.stack(values)
        else:
            arrays = [np.asarray(v) for v in values]
            out[key] = np.concatenate(arrays) if arrays[0].shape[0] == 1 else np.stack(arrays)
    return out
