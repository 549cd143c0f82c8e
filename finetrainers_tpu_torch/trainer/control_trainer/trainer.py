"""Control trainer: channel-concat control-conditioned training (port of
`finetrainers_tpu/trainer/control_trainer/trainer.py`).

- The transformer is built with its patch embed, the injection layer, widened
  to 2x the latent channels (3x with `--frame_conditioning_concatenate_mask`)
  for the control latents joined to the noisy latents (:32-56). The widening
  starts from the spec's base channel count, which the port keeps (JAX's
  spec writes the widened count back, so its reload for the final validation
  widens twice; ROADMAP.md section 3).
- `control-lora` trains every LoRA factor, the injection layer at full rank
  and, under `--train_qk_norm`, the qk norms (:58-80); the injection layer is
  kept in fp32, as JAX keeps every parameter, and cast to the compute dtype
  at each call. `control-full-finetune` trains everything.
- The remat policy applies per block, as the SFT trainer's (JAX's control
  trainer leaves `spec.gradient_checkpointing` unset and falls back to one
  policy over the whole forward; the values are the same).
- The dataset is wrapped in `IterableControlDataset`; the SFT data stage
  hands its control media to `prepare_latents` (:82-107).
- Each save under `control-lora` exports the adapter and, beside it,
  `control_aux_weights.safetensors` (`lora.save_control_aux_weights`: the
  trained non-LoRA weights under the JAX package's flat flax names and
  layouts, so each package reads the other's file; :120-156); the SFT
  trainer's final validation reloads a fresh widened model with both applied
  (:109-118).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from ...lora import lora_mask, trainable_mask
from ..sft_trainer.trainer import SFTTrainer
from .data import IterableControlDataset


def widened_in_channels(spec, args) -> int:
    """2x the base latent channels, 3x with the concatenated mask (JAX :45-48)."""
    base = spec.transformer_config["in_channels"]
    return base * (3 if args.frame_conditioning_concatenate_mask else 2)


class ControlTrainer(SFTTrainer):
    # ---------------------------------------------------------------- prepare
    def _prepare_models(self) -> None:
        spec, args = self.model_specification, self.args
        for attr in ("frame_conditioning_type", "frame_conditioning_index", "frame_conditioning_concatenate_mask"):
            if hasattr(spec, attr):
                setattr(spec, attr, getattr(args, attr))
        super()._prepare_models()

    def _load_diffusion_models(self) -> Dict[str, Any]:
        spec = self.model_specification
        return spec.load_diffusion_models(new_in_features=widened_in_channels(spec, self.args))

    def _trainable_mask(self, module) -> Dict[str, bool]:
        """Under `control-lora` the LoRA factors, the injection layer (made an
        fp32 master, cast to the compute dtype at each call) and, under
        `--train_qk_norm`, the qk norms (JAX :58-80); else every parameter."""
        spec = self.model_specification
        if self.args.training_type != "control-lora":
            return trainable_mask(module, lambda name: True)
        injection = module.get_submodule(spec.control_injection_layer_name)
        for name, param in list(injection.named_parameters(recurse=False)):
            setattr(injection, name, torch.nn.Parameter(param.detach().float()))
        prefix = spec.control_injection_layer_name + "."
        qk = spec._qk_norm_identifiers if self.args.train_qk_norm else []
        lora = lora_mask(module)
        return trainable_mask(module, lambda name: lora[name] or name.startswith(prefix)
                              or any(re.search(p, name) for p in qk))

    def _wrap_dataset(self, dataset):
        return IterableControlDataset(dataset, control_type=self.args.control_type)
