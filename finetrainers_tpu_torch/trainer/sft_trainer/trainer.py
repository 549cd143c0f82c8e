"""SFT trainer (port of `finetrainers_tpu/trainer/sft_trainer/trainer.py`).

Ported: the stages `_prepare_models`, `_prepare_trainable_parameters`,
`_prepare_for_training` (optimizer, LR schedule and gradient accumulation as
`optax.MultiSteps`; no trackers) and `_prepare_checkpointing` (checkpoints,
resume, the LoRA or full-rank export after each save), the train step of
`_build_train_step` as `train_step`, and `train(batches)`, a loop over
precomputed (conditions, latent conditions) batches that advances
`TrainState`, saves on the checkpoint cadence and once more at its end. The
dataset, precompute, validation and preemption stages are not ported yet, so
`run()` raises (ROADMAP.md queue 1 item 7).

The step runs eagerly: the forward through the spec, the loss, `backward()`
(through K4, so the flash backward kernels on the card), the global-norm clip,
the optimizer update and the schedule's count. LoRA training leaves every
parameter but the LoRA factors with `requires_grad=False`.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from ...checkpoint import Checkpointer
from ...functional.diffusion import compute_loss_weighting, default_flow_shift
from ...logging import get_logger
from ...lora import lora_mask, split_params, trainable_mask
from ...optimizer import MultiSteps, get_lr_scheduler, get_optimizer
from ...state import TrainState
from ..base import Trainer

logger = get_logger(__name__)


class SFTTrainer(Trainer):
    def __init__(self, args, model_specification) -> None:
        super().__init__(args, model_specification)
        self.transformer = None
        self.scheduler = None
        self.optimizer = None
        self.checkpointer = None
        self._saved_step = None  # the last step this trainer saved or resumed from

    def run(self) -> None:
        raise NotImplementedError(
            "SFTTrainer.run needs the data stage (dataset, precompute, validation), which is not ported yet; "
            "see ROADMAP.md queue 1 item 7. Call train(batches) with precomputed batches instead."
        )

    # ---------------------------------------------------------------- prepare
    def prepare(self) -> None:
        """Load the models, select the trainable parameters, build the
        optimizer and the checkpointer, and resume from
        `args.resume_from_checkpoint` ("latest" or a step) where it names a
        saved step."""
        self._prepare_models()
        self._prepare_trainable_parameters()
        self._prepare_for_training()
        self._prepare_checkpointing()

    def _prepare_models(self) -> None:
        """The transformer and its scheduler. Training on precomputed latents
        needs neither the VAE nor the text encoder; they load with the
        precompute stage (ROADMAP.md queue 1 item 7)."""
        spec = self.model_specification
        if self.args.training_type == "lora":
            spec.lora_rank = self.args.rank
            spec.lora_alpha = self.args.lora_alpha
        if self.args.gradient_checkpointing:
            spec.gradient_checkpointing = self.args.gradient_checkpointing_type
        diffusion = spec.load_diffusion_models()
        self.transformer = diffusion["transformer"]
        self.scheduler = diffusion["scheduler"]

    def _prepare_trainable_parameters(self) -> None:
        module = self.transformer.module
        if self.args.training_type == "lora":
            mask = lora_mask(module)
        else:
            mask = trainable_mask(module, lambda name: True)
        self._trainable, self._frozen = split_params(module, mask)
        n_train = sum(p.numel() for p in self._trainable.values())
        n_total = n_train + sum(p.numel() for p in self._frozen.values())
        self.state.num_trainable_parameters = n_train
        logger.info(f"Trainable params: {n_train:,} / {n_total:,}")

    def _prepare_for_training(self) -> None:
        args = self.args
        self._lr_schedule = get_lr_scheduler(
            args.lr_scheduler, args.lr, warmup_steps=args.lr_warmup_steps,
            train_steps=args.train_steps, num_cycles=args.lr_num_cycles, power=args.lr_power,
        )
        self.optimizer = get_optimizer(
            args.optimizer, self._trainable.values(), self._lr_schedule, beta1=args.beta1, beta2=args.beta2,
            epsilon=args.epsilon, weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        )
        if args.gradient_accumulation_steps > 1:
            self.optimizer = MultiSteps(self.optimizer, args.gradient_accumulation_steps)

    def _prepare_checkpointing(self) -> None:
        args = self.args
        self.checkpointer = Checkpointer(
            os.path.join(args.output_dir, "checkpoints"), checkpointing_steps=args.checkpointing_steps,
            checkpointing_limit=args.checkpointing_limit,
            # Not a bound method: a trainer referenced from its own checkpointer is freed (with its model's
            # device memory) only when the cycle collector runs.
            callback_fn=functools.partial(_export, args, self.model_specification, self.transformer),
        )
        if args.resume_from_checkpoint is not None:
            step = -1 if args.resume_from_checkpoint == "latest" else int(args.resume_from_checkpoint)
            restored = self.checkpointer.load(step)
            if restored is not None:
                self._load_checkpoint_state(restored[1])
                self._saved_step = restored[0]
                logger.info(f"Resumed from checkpoint at step {self.state.train_state.step}")

    # ------------------------------------------------------------- checkpoint
    def _checkpoint_state(self) -> Dict[str, Any]:
        """What a resume needs: the trainable parameters, the optimizer (its
        moments and step, the schedule's count, the accumulator's micro-step
        and running mean), the generator the draws come from (the JAX trainer
        folds the step into its key instead) and the train state."""
        return {
            "trainable": {name: param.detach() for name, param in self._trainable.items()},
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
            "train_state": self.state.train_state.state_dict(),
        }

    def _load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            for name, param in self._trainable.items():
                param.copy_(state["trainable"][name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.state.train_state.load_state_dict(state["train_state"])

    def _save_checkpoint(self, force: bool = False) -> None:
        step = self.state.train_state.step
        if self._saved_step == step:
            return  # the cadence save (or the resume) already covered this step
        if self.checkpointer.save(step, self._checkpoint_state(), force=force):
            self._saved_step = step

    # ------------------------------------------------------------------ train
    def forward_backward(self, conditions: Dict[str, torch.Tensor], latent_conditions: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loss of one batch and its gradients: sigmas, the spec forward,
        the weighted flow-matching loss, `backward()` (which adds into `.grad`).
        Returns (loss, max_loss) as device scalars.

        Random draws come from `generator` (the trainer's by default), or from
        `draws` where given: "sigmas" (the raw draw of the timestep density,
        (B,)) and the spec forward's "posterior", "noise", "first_frame" and
        "first_frame_u"."""
        args = self.args
        spec = self.model_specification
        generator = self.generator if generator is None else generator
        draws = draws or {}
        sigmas = self.scheduler.training_sigmas(
            latent_conditions["latents"].shape[0],
            flow_weighting_scheme=args.flow_weighting_scheme,
            flow_logit_mean=args.flow_logit_mean,
            flow_logit_std=args.flow_logit_std,
            flow_mode_scale=args.flow_mode_scale,
            generator=generator,
            draw=None if draws.get("sigmas") is None else torch.as_tensor(draws["sigmas"]),
            device=spec.device,
        )
        if args.flow_shift != 1.0 and self.scheduler.shift == 1.0:
            sigmas = default_flow_shift(sigmas, args.flow_shift)

        with self.attention_provider_ctx():
            pred, target, sigmas_out = spec.forward(self.transformer, conditions, latent_conditions, sigmas,
                                                    generator=generator, draws=draws)
        weights = compute_loss_weighting(args.flow_weighting_scheme, sigmas=sigmas_out)
        w = weights.reshape(weights.shape + (1,) * (pred.ndim - 1))
        per_sample = w * (pred.float() - target.float()) ** 2
        loss = per_sample.mean()
        max_loss = per_sample.mean(dim=tuple(range(1, per_sample.ndim))).max()
        loss.backward()
        return loss.detach(), max_loss.detach()

    def train_step(self, conditions: Dict[str, torch.Tensor], latent_conditions: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One micro-step (`forward_backward`, then the optimizer's step: the
        clipped update and the schedule's count, or under gradient
        accumulation the running mean, updating on every k-th) -> {"loss",
        "max_loss", "grad_norm"} as device scalars, grad_norm the
        micro-batch's before clipping. Nothing here waits for the device."""
        self.optimizer.zero_grad()
        loss, max_loss = self.forward_backward(conditions, latent_conditions, generator, draws)
        grad_norm = self.optimizer.step()
        return {"loss": loss, "max_loss": max_loss, "grad_norm": grad_norm}

    def train(self, batches: Iterable[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]) -> TrainState:
        """Train on (conditions, latent conditions) batches until the iterable
        ends or `args.train_steps` micro-steps are reached; records loss and
        max loss every `args.logging_steps` steps, saves a checkpoint every
        `args.checkpointing_steps` steps and once more at the end (unless that
        step is saved). After a resume, pass the batches from the resumed step
        on: the position in the data is not saved."""
        if self.optimizer is None:
            self.prepare()
        args = self.args
        train_state = self.state.train_state
        for conditions, latent_conditions in batches:
            if train_state.step >= args.train_steps:
                break
            out = self.train_step(conditions, latent_conditions)
            train_state.step += 1
            train_state.observed_data_samples += latent_conditions["latents"].shape[0]
            if train_state.step % args.logging_steps == 0 or train_state.step == args.train_steps:
                train_state.global_avg_losses.append(float(out["loss"]))
                train_state.global_max_losses.append(float(out["max_loss"]))
                train_state.log_steps.append(train_state.step)
                logger.info(f"step {train_state.step}/{args.train_steps} loss={train_state.global_avg_losses[-1]:.4f} "
                            f"grad_norm={float(out['grad_norm']):.4f}")
            if args.checkpointing_steps > 0 and train_state.step % args.checkpointing_steps == 0:
                self._save_checkpoint()
        self._save_checkpoint(force=True)
        return train_state


def _export(args, spec, transformer, state: Dict[str, Any]) -> None:
    """After each save of `state`: the adapter to `output_dir/lora_weights/<step>`,
    or for full-rank training the transformer to `output_dir/model_weights/<step>`."""
    step = state["train_state"]["step"]
    if args.training_type == "lora":
        lora_config = {"r": args.rank, "lora_alpha": args.lora_alpha, "target_modules": args.target_modules}
        spec._save_lora_weights(os.path.join(args.output_dir, "lora_weights", f"{step:06d}"), state["trainable"],
                                lora_config)
    else:
        spec._save_model(os.path.join(args.output_dir, "model_weights", f"{step:06d}"), transformer)
