"""SFT trainer (port of `finetrainers_tpu/trainer/sft_trainer/trainer.py`).

`run()` is the JAX trainer's lifecycle at one rank: the models, the trainable
parameters, the optimizer (LR schedule, clip, gradient accumulation as
`optax.MultiSteps`) and the trackers, the dataset and its precompute, the
checkpoints (resuming the loader too), then the train loop with its logging,
cadence saves, validation, preemption and the final export and model card.
`prepare()` and `train(batches)` are the same stages without the data stage,
for callers that bring precomputed (conditions, latent conditions) batches.

The step runs eagerly: the forward through the spec, the loss, `backward()`
(through K4, so the flash backward kernels on the card), the global-norm clip,
the optimizer update and the schedule's count. LoRA training leaves every
parameter but the LoRA factors with `requires_grad=False`.

The data stage (JAX :318-383, :657-698): datasets from `--dataset_config`,
decoded, bucketed and combined through a seeded shuffle buffer, a one-rank
`DPDataLoader`, and precompute rounds of `precomputation_items` samples (the
spec's text conditions and VAE moments, in memory or as `.npz` files) that
feed the resolution sampler. A checkpoint saves the loader's state from the
start of the current round and how many of the round's items were taken;
a resume restores the loader there, precomputes the round again and skips
those items, so the resumed run trains on the unbroken run's samples (the
JAX trainer restarts a `--precomputation_once` run's set from the loader's
position instead). Under prefetch the state saved is the one carried by the
last batch trained on, not the loader's, which runs ahead. Each step logs
the `sample_id`s of its batch (`train/sample_ids`).
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import re
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from ...args import DEFAULT_TARGET_MODULES, LORA_TRAINING_TYPES
from ...checkpoint import Checkpointer
from ...data import (
    DevicePrefetcher,
    DPDataLoader,
    ResolutionSampler,
    ValidationDataset,
    combine_datasets,
    initialize_dataset,
    initialize_preprocessor,
    to_device,
    wrap_iterable_dataset_for_preprocessing,
)
from ...data.utils import save_image, save_video
from ...functional.diffusion import compute_loss_weighting, default_flow_shift
from ...logging import get_logger
from ...lora import (
    AUX_WEIGHTS_NAME,
    LORA_WEIGHTS_NAME,
    apply_auxiliary_weights,
    apply_lora_state_dict,
    load_lora_weights,
    lora_mask,
    save_control_aux_weights,
    split_params,
    trainable_mask,
)
from ...optim8bit import jax_row_dims
from ...optimizer import MultiSteps, get_lr_scheduler, get_optimizer
from ...state import TrainState
from ...trackers import BaseTracker, initialize_trackers
from ...utils.fp8 import apply_layerwise_storage_dtype, count_fp8_bytes
from ...utils.int8 import apply_int8_storage, count_int8_bytes
from ...utils.memory import get_memory_statistics
from ..base import Trainer

logger = get_logger(__name__)


class SFTTrainer(Trainer):
    def __init__(self, args, model_specification) -> None:
        super().__init__(args, model_specification)
        self.transformer = None
        self.scheduler = None
        self.optimizer = None
        self.checkpointer = None
        self.vae = None
        self.condition_models = None
        self.dataloader = None
        self.tracker: BaseTracker = BaseTracker()
        self._saved_step = None  # the last step this trainer saved or resumed from
        self._resume_round_items = 0  # items of the resumed precompute round that were trained on
        self._stream: Optional[Iterator] = None
        self._live_snapshot = None  # the loader snapshot of the batch the stream produced last
        self._consumed_snapshot = None  # ... of the batch trained on last
        self._validation_pipeline = None

    # ------------------------------------------------------------------- run
    def run(self) -> None:
        """Train as `args` say, from the datasets of `args.dataset_config`."""
        try:
            self._prepare_models()
            self._prepare_trainable_parameters()
            self._prepare_for_training()
            self._prepare_trackers()
            self._prepare_dataset()
            self._prepare_checkpointing()
            self._train()
        except Exception as e:
            logger.error(f"Error during training: {e}")
            raise
        finally:
            # The stream's frame refers to this trainer: dropped here, a trainer that is dropped frees its model.
            if isinstance(self._stream, DevicePrefetcher):
                self._stream.stop()
            elif self._stream is not None:
                self._stream.close()
            self._stream = None

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
        """The transformer and its scheduler. The VAE and the text encoder load
        with the data stage (`_prepare_dataset`)."""
        spec = self.model_specification
        if self.args.validation_dataset_file:
            spec.check_serving_text_encoders()  # validation serves as the runner does (ROADMAP.md section 3 finding 14)
        if self.args.training_type in LORA_TRAINING_TYPES:
            spec.lora_rank = self.args.rank
            spec.lora_alpha = self.args.lora_alpha
        if self.args.gradient_checkpointing:
            spec.gradient_checkpointing = self.args.gradient_checkpointing_type
        diffusion = self._load_diffusion_models()
        self.transformer = diffusion["transformer"]
        self.scheduler = diffusion["scheduler"]

    def _load_diffusion_models(self) -> Dict[str, Any]:
        """The spec's transformer and scheduler (the control trainer widens the transformer)."""
        return self.model_specification.load_diffusion_models()

    def _trainable_mask(self, module) -> Dict[str, bool]:
        """Which parameters train: the LoRA factors under `lora`, else all."""
        if self.args.training_type == "lora":
            return lora_mask(module)
        return trainable_mask(module, lambda name: True)

    def _prepare_trainable_parameters(self) -> None:
        module = self.transformer.module
        self._trainable, self._frozen = split_params(module, self._trainable_mask(module))
        self._apply_weight_storage(module)
        n_train = sum(p.numel() for p in self._trainable.values())
        n_total = n_train + sum(p.numel() for p in self._frozen.values())
        self.state.num_trainable_parameters = n_train
        logger.info(f"Trainable params: {n_train:,} / {n_total:,}")
        if self.args.training_type in LORA_TRAINING_TYPES:
            self._check_target_modules()

    def _apply_weight_storage(self, module) -> None:
        """Under `--layerwise_upcasting_modules transformer`, store the frozen
        linear weights as `--layerwise_upcasting_storage_dtype` says (JAX
        :127-156): int8 codes with per-output-channel scales, whose products
        then run on int8 GEMMs (`utils.int8`), or fp8, cast to the compute dtype
        where used (`utils.fp8`); the skip patterns keep the rest as it is."""
        args = self.args
        if "transformer" not in (args.layerwise_upcasting_modules or []):
            return
        skip = args.layerwise_upcasting_skip_modules_pattern
        if args.layerwise_upcasting_storage_dtype == torch.int8:
            apply_int8_storage(module, skip)
            logger.info(f"Stored {count_int8_bytes(module):,} bytes of frozen transformer weights as int8")
        else:
            apply_layerwise_storage_dtype(module, args.layerwise_upcasting_storage_dtype, skip)
            logger.info(f"Stored {count_fp8_bytes(module):,} bytes of frozen transformer weights as fp8")
        self._frozen = {name: p for name, p in module.named_parameters() if name not in self._trainable}

    def _check_target_modules(self) -> None:
        """Every LoRA layer trains, as in the JAX trainer; warn once where an
        explicit `--target_modules` selects fewer of them."""
        if self.args.target_modules == DEFAULT_TARGET_MODULES:
            return
        pattern = re.compile(self.args.target_modules)
        layers: Dict[str, int] = {}
        for name, param in self._trainable.items():
            if ".lora_" not in name:
                continue  # a control trainer's full-rank injection layer
            layer = name.split(".lora_")[0]
            layers[layer] = layers.get(layer, 0) + param.numel()
        selected = {layer: n for layer, n in layers.items() if pattern.search(layer)}
        if len(selected) < len(layers):
            logger.warning(
                f"--target_modules {self.args.target_modules!r} matches {len(selected)} of the {len(layers)} LoRA "
                f"layers, but every LoRA layer trains: {sum(layers.values()):,} parameters trained against "
                f"{sum(selected.values()):,} selected")

    def _prepare_for_training(self) -> None:
        args = self.args
        self._lr_schedule = get_lr_scheduler(
            args.lr_scheduler, args.lr, warmup_steps=args.lr_warmup_steps,
            train_steps=args.train_steps, num_cycles=args.lr_num_cycles, power=args.lr_power,
        )
        self.optimizer = get_optimizer(
            args.optimizer, self._trainable.values(), self._lr_schedule, beta1=args.beta1, beta2=args.beta2,
            epsilon=args.epsilon, weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
            quant_dims=jax_row_dims(self.transformer.module, self._trainable),
        )
        if args.gradient_accumulation_steps > 1:
            self.optimizer = MultiSteps(self.optimizer, args.gradient_accumulation_steps)

    def _prepare_trackers(self) -> None:
        """JSONL under `output_dir/logging_dir` unless `--report_to` names
        another tracker (the JAX trainer logs to JSONL for "none" too)."""
        args = self.args
        os.makedirs(args.output_dir, exist_ok=True)
        self.tracker = initialize_trackers(
            [args.report_to] if args.report_to != "none" else ["jsonl"], experiment_name=args.tracker_name,
            config=_jsonable(args.to_dict()), log_dir=os.path.join(args.output_dir, args.logging_dir))

    def _prepare_dataset(self) -> None:
        args = self.args
        if args.dataset_config is None:
            raise ValueError("run() trains from --dataset_config; call train(batches) with precomputed batches instead")
        spec = self.model_specification
        self.vae = spec.load_latent_models()["vae"]
        if args.enable_slicing:
            self.vae.enable_slicing()
        if args.enable_tiling:
            self.vae.enable_tiling()
        self.condition_models = spec.load_condition_models()
        with open(args.dataset_config) as f:
            config = json.load(f)
        datasets = []
        for entry in config["datasets"]:
            root = entry.get("data_root") or entry.get("dataset_file")
            dataset_type = entry.get("dataset_type", "video")
            ds = initialize_dataset(root, dataset_type, infinite=True, caption_options=entry.get("caption_options"))
            if args.precomputation_once and not getattr(ds, "_precomputable_once", False):
                raise ValueError(f"Dataset {root} does not support precomputing all embeddings at once.")
            datasets.append(wrap_iterable_dataset_for_preprocessing(ds, dataset_type, {
                "id_token": entry.get("id_token"),
                "image_resolution_buckets": [tuple(b) for b in entry.get("image_resolution_buckets") or []] or None,
                "video_resolution_buckets": [tuple(b) for b in entry.get("video_resolution_buckets") or []] or None,
                "reshape_mode": entry.get("reshape_mode", "bicubic"),
                "remove_common_llm_caption_prefixes": entry.get("remove_common_llm_caption_prefixes", False),
                "rename_columns": entry.get("rename_columns"),
                "decode_workers": args.dataloader_num_workers,
            }))
        self.dataset = self._wrap_dataset(combine_datasets(datasets, buffer_size=args.dataset_shuffle_buffer_size,
                                                           shuffle=args.dataset_shuffle_buffer_size > 1))
        self.dataloader = DPDataLoader(rank=0, dataset=self.dataset, batch_size=1,
                                       num_workers=args.dataloader_num_workers, collate_fn=lambda items: items[0])
        self._round_ids: List[Any] = []  # the sample ids of the current precompute round, in order
        self.preprocessor = initialize_preprocessor(
            rank=0,
            num_items=args.precomputation_items if args.enable_precomputation else args.batch_size * 2,
            # Partials, not closures over the trainer: the preprocessor would keep it alive in a cycle.
            processor_fn={"condition": functools.partial(_process_condition, spec, self.condition_models,
                                                         self._round_ids),
                          "latent": functools.partial(_process_latent, spec, self.vae)},
            save_dir=args.precomputation_dir or os.path.join(args.output_dir, "precomputed"),
            enable_precomputation=args.enable_precomputation,
        )

    def _wrap_dataset(self, dataset):
        """The combined dataset as the data stage reads it (the control trainer adds control media)."""
        return dataset

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
        folds the step into its key instead), the train state and, in a run
        with a data stage, the loader's snapshot of the last batch trained on."""
        state = {
            "trainable": {name: param.detach() for name, param in self._trainable.items()},
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
            "train_state": self.state.train_state.state_dict(),
        }
        if self.dataloader is not None and self._consumed_snapshot is not None:
            state["dataloader"] = self._consumed_snapshot
        return state

    def _load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            for name, param in self._trainable.items():
                param.copy_(state["trainable"][name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.state.train_state.load_state_dict(state["train_state"])
        if self.dataloader is not None and "dataloader" in state:
            self.dataloader.load_state_dict(state["dataloader"]["loader"])
            self._resume_round_items = state["dataloader"]["round_items"]
            self._consumed_snapshot = state["dataloader"]

    def _save_checkpoint(self, force: bool = False) -> None:
        step = self.state.train_state.step
        if self._saved_step == step:
            return  # the cadence save (or the resume) already covered this step
        with self.tracker.timed("timing/checkpoint"):
            if self.checkpointer.save(step, self._checkpoint_state(), force=force):
                self._saved_step = step

    # ------------------------------------------------------------------ train
    def forward_backward(self, conditions: Dict[str, torch.Tensor], latent_conditions: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loss of one batch and its gradients: sigmas, the spec forward,
        the weighted loss (the flow-matching weights, or DDIM's 1 / (1 - alpha_bar)
        where the scheduler has `alphas`), `backward()` (which adds into `.grad`).
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
        if args.flow_shift != 1.0 and getattr(self.scheduler, "shift", None) == 1.0:  # DDIM has no shift
            sigmas = default_flow_shift(sigmas, args.flow_shift)

        # The backward runs under the provider too: a remat policy recomputes the forward there.
        with self.attention_provider_ctx():
            pred, target, sigmas_out = spec.forward(self.transformer, conditions, latent_conditions, sigmas,
                                                    generator=generator, draws=draws)
            alphas = getattr(self.scheduler, "alphas", None)
            if alphas is not None:  # DDIM: 1 / (1 - alpha_bar[t]) (JAX :272-277)
                alphas = alphas.to(sigmas_out.device)[self.scheduler.timesteps(sigmas_out)]
                weights = compute_loss_weighting(args.flow_weighting_scheme, alphas=alphas)
            else:
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

    def _record_step(self, out: Dict[str, torch.Tensor], batch_size: int, sample_ids=None) -> None:
        """Advance the train state by one step of `batch_size` samples and, on
        the logging cadence and at the last step, log its scalars (a sync)."""
        args = self.args
        train_state = self.state.train_state
        train_state.step += 1
        train_state.observed_data_samples += batch_size
        step = train_state.step
        if step % args.logging_steps != 0 and step != args.train_steps:
            return
        loss, max_loss, grad_norm = float(out["loss"]), float(out["max_loss"]), float(out["grad_norm"])
        train_state.global_avg_losses.append(loss)
        train_state.global_max_losses.append(max_loss)
        train_state.log_steps.append(step)
        metrics = {"train/global_avg_loss": loss, "train/global_max_loss": max_loss, "train/grad_norm": grad_norm,
                   "train/lr": float(self._lr_schedule(step)),
                   "train/observed_data_samples": train_state.observed_data_samples}
        if sample_ids is not None:
            metrics["train/sample_ids"] = ",".join(str(i) for i in sample_ids)
        self.tracker.log(metrics, step=step)
        logger.info(f"step {step}/{args.train_steps} loss={loss:.4f} grad_norm={grad_norm:.4f}")

    def train(self, batches: Iterable[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]) -> TrainState:
        """Train on (conditions, latent conditions) batches until the iterable
        ends or `args.train_steps` micro-steps are reached; records loss and
        max loss every `args.logging_steps` steps, saves a checkpoint every
        `args.checkpointing_steps` steps and once more at the end (unless that
        step is saved). After a resume, pass the batches from the resumed step
        on: the position in `batches` is not saved (`run()` saves its loader's)."""
        if self.optimizer is None:
            self.prepare()
        args = self.args
        train_state = self.state.train_state
        for conditions, latent_conditions in batches:
            if train_state.step >= args.train_steps:
                break
            self._record_step(self.train_step(conditions, latent_conditions), latent_conditions["latents"].shape[0])
            if args.checkpointing_steps > 0 and train_state.step % args.checkpointing_steps == 0:
                self._save_checkpoint()
        self._save_checkpoint(force=True)
        return train_state

    def _train(self) -> None:
        """The loop of `run()` (JAX :445-656 at one rank)."""
        args = self.args
        train_state = self.state.train_state
        device = self.model_specification.device
        logger.info(f"Memory before training: {get_memory_statistics(device)}")
        logger.info(f"Starting training: {args.train_steps} steps")
        stream = self._batch_stream(ResolutionSampler(args.batch_size, self.model_specification._resolution_dim_keys))
        if args.dataloader_num_workers > 0 or args.pin_memory:
            # Host decode, precompute refills, collation and the copy to the card run ahead on a thread.
            stream = DevicePrefetcher(stream, device, depth=max(args.dataloader_num_workers, 1) + 1,
                                      snapshot_fn=lambda: self._live_snapshot)
        self._stream = stream
        prev_sigterm = self._install_preemption_handler()
        profiler = None
        try:
            while train_state.step < args.train_steps and train_state.observed_data_samples < args.max_data_samples:
                with self.tracker.timed("timing/batch_prep"):
                    conditions, latents, sample_ids = next(stream)
                    if isinstance(stream, DevicePrefetcher):
                        self._consumed_snapshot = stream.consumed_state
                    else:
                        self._consumed_snapshot = self._live_snapshot
                        conditions, latents = to_device((conditions, latents), device)
                if args.enable_profiling and train_state.step == args.profiling_start_step:
                    from ...utils.timing import ProfilerTrace

                    profiler = ProfilerTrace(os.path.join(args.output_dir, "traces")).__enter__()
                with self.tracker.timed("timing/train_step"):
                    out = self.train_step(conditions, latents)
                self._record_step(out, latents["latents"].shape[0], sample_ids)
                if profiler is not None and train_state.step >= args.profiling_start_step + args.profiling_num_steps:
                    profiler.__exit__(None, None, None)
                    logger.info(f"Profiler trace written to {profiler.log_dir}")
                    profiler = None
                if args.checkpointing_steps > 0 and train_state.step % args.checkpointing_steps == 0:
                    self._save_checkpoint()
                if args.validation_steps > 0 and args.validation_dataset_file and (
                        train_state.step % args.validation_steps == 0):
                    self._validate(train_state.step)
                if self._preemption_requested:
                    logger.info(f"Preemption notice received; saving checkpoint at step {train_state.step} "
                                "and exiting cleanly")
                    break
            # The handler stays installed through the epilogue: a repeated notice must not kill the final save.
            self._save_checkpoint(force=True)
            if isinstance(stream, DevicePrefetcher):
                stream.stop()
            if args.validation_dataset_file:
                self._validate(train_state.step, final=True)
            self._finalize_run()
            logger.info(f"Memory after training: {get_memory_statistics(device)}")
            self.tracker.finish()
        finally:
            if profiler is not None:
                profiler.__exit__(None, None, None)
            if prev_sigterm is not None:
                import signal

                signal.signal(signal.SIGTERM, prev_sigterm[0] or signal.SIG_DFL)

    def _batch_stream(self, sampler: ResolutionSampler) -> Iterator[Tuple[Dict, Dict, List]]:
        """(conditions, latent conditions, sample ids) batches on the host,
        forever: precompute rounds of the loader's samples (refilled when a
        round is spent, JAX :657-698), through the resolution sampler, collated.
        Before each batch is yielded, `_live_snapshot` becomes the loader's state
        at the start of its round and the number of the round's items taken.
        After a resume the first round skips the items the saved run took
        (feeding them to the sampler, whose batches it drops)."""
        args = self.args
        spec = self.model_specification
        data_iterator = iter(self.dataloader)
        skip, self._resume_round_items = self._resume_round_items, 0
        round_start = condition_iter = latent_iter = None
        taken = 0
        while True:
            if condition_iter is None or self.preprocessor.requires_data:
                with self.tracker.timed("timing/precompute"):
                    round_start, taken = _jsonable(self.dataloader.state_dict()), 0
                    self._round_ids.clear()
                    consume = self.preprocessor.consume_once if args.precomputation_once else self.preprocessor.consume
                    condition_iter = iter(consume("condition", data_iterator, cache_samples=True))
                    latent_iter = iter(consume("latent", data_iterator, use_cached_samples=True, drop_samples=True))
                if args.precomputation_once:  # the set cycles: a position past it is the same position modulo its size
                    skip %= max(len(self._round_ids), 1)
            try:
                item = (next(condition_iter), next(latent_iter), self._round_ids[taken % len(self._round_ids)])
            except StopIteration:
                condition_iter = None
                continue
            taken += 1
            sampler.consume((item[0], item[2]), item[1])
            if taken <= skip:  # the saved run took this item: its batches were trained on
                while sampler.ready:
                    sampler.get_batch()
                continue
            if not sampler.ready:
                continue
            cond_list, lat_list = sampler.get_batch()
            self._live_snapshot = {"loader": round_start, "round_items": taken}
            yield (spec.collate_conditions([c for c, _ in cond_list]), spec.collate_latents(lat_list),
                   [i for _, i in cond_list])

    # -------------------------------------------------------------- lifecycle
    def _finalize_run(self) -> None:
        """The model card (JAX :700-723; nothing is pushed)."""
        from ...utils.hub import save_model_card

        args = self.args
        media = "video" if "video" in (args.model_name or "") or args.model_name in ("wan", "dummy") else "image"
        save_model_card(
            args.output_dir, base_model=args.pretrained_model_name_or_path or "unknown", model_name=args.tracker_name,
            training_details={
                "training_type": args.training_type,
                "steps": self.state.train_state.step,
                "learning_rate": args.lr,
                "trainable_parameters": self.state.num_trainable_parameters,
                "final_loss": (self.state.train_state.global_avg_losses or [None])[-1],
            },
            media=media,
        )

    def _install_preemption_handler(self):
        """With --checkpoint_on_preemption, SIGTERM sets a flag the loop reads
        after each step: the step finishes, a full checkpoint is saved and the
        run ends cleanly. Returns a 1-tuple of the previous handler when one was
        installed, else None."""
        self._preemption_requested = False
        if not self.args.checkpoint_on_preemption:
            return None
        import signal

        def _on_sigterm(signum, frame):
            self._preemption_requested = True

        try:
            return (signal.signal(signal.SIGTERM, _on_sigterm),)
        except ValueError:  # not the main thread of the main interpreter
            logger.warning("checkpoint_on_preemption: cannot install a SIGTERM handler outside the main thread; "
                           "preemption checkpointing disabled")
            return None

    # -------------------------------------------------------------- validation
    def _load_exported_transformer(self):
        """A fresh base transformer with the latest export applied (the LoRA
        adapter and the control aux weights beside it, or the full-rank
        model), or None when nothing was exported (JAX :821-855)."""
        args = self.args
        lora = args.training_type in LORA_TRAINING_TYPES
        export_dir = _latest_export(os.path.join(args.output_dir, "lora_weights" if lora else "model_weights"))
        if export_dir is None:
            return None
        handle = self._load_diffusion_models()["transformer"]
        if lora:
            state, _ = load_lora_weights(os.path.join(export_dir, LORA_WEIGHTS_NAME))
            apply_lora_state_dict(handle.module, state)
            apply_auxiliary_weights(handle.module, os.path.join(export_dir, AUX_WEIGHTS_NAME),
                                    key_map=self.model_specification.transformer_key_map)
        else:
            from ...utils.serialization import safetensors_load_dict

            state = safetensors_load_dict(os.path.join(export_dir, "diffusion_pytorch_model.safetensors"))
            handle.module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=False)
        return handle

    def _init_validation_pipeline(self, final: bool = False):
        """Periodic validation runs the live weights through one reused pipeline;
        the final one reloads fresh base weights with the exports applied, which
        proves the exports complete (JAX :857-884)."""
        spec = self.model_specification
        text_encoder = self.condition_models["text_encoder"]
        if final:
            handle = self._load_exported_transformer()
            if handle is not None:
                return spec.load_pipeline(transformer=handle, vae=self.vae, text_encoder=text_encoder)
            logger.warning("No export artifacts found; final validation uses live weights")
        if self._validation_pipeline is None:
            self._validation_pipeline = spec.load_pipeline(transformer=self.transformer, vae=self.vae,
                                                           text_encoder=text_encoder)
        return self._validation_pipeline

    def _validate(self, step: int, final: bool = False) -> None:
        args = self.args
        logger.info(f"Running validation at step {step}" + (" (final, from exports)" if final else ""))
        with self.tracker.timed("timing/validation"):
            pipeline = self._init_validation_pipeline(final=final)
            artifacts = []
            with self.attention_provider_ctx(training=False):
                for sample in ValidationDataset(args.validation_dataset_file):
                    sample = {k: v for k, v in sample.items() if v is not None}
                    for artifact in self.model_specification.validation(pipeline, **sample):
                        artifact.caption = artifact.caption or sample.get("prompt")
                        artifacts.append(artifact)
            del pipeline
            out_dir = pathlib.Path(args.output_dir) / "validation" / f"{step:06d}"
            out_dir.mkdir(parents=True, exist_ok=True)
            logged = []
            for i, artifact in enumerate(artifacts):
                path = out_dir / f"artifact-0-{i}.{artifact.file_extension}"
                (save_video if artifact.type == "video" else save_image)(artifact.value, str(path))
                logged.append({"type": artifact.type, "path": str(path), "caption": artifact.caption})
        self.tracker.log_artifacts(logged, step=step)
        logger.info(f"Validation wrote {len(artifacts)} artifacts to {out_dir}")


def _process_condition(spec, condition_models, round_ids: List[Any], **sample) -> Dict[str, Any]:
    """A sample's text conditions; its id joins the round's."""
    round_ids.append(sample.get("sample_id"))
    return spec.prepare_conditions(caption=sample.get("caption", ""), **condition_models)


def _process_latent(spec, vae, **sample) -> Dict[str, Any]:
    """A sample's VAE moments and, for a control spec, its control media's (the
    posterior is sampled in the spec's forward; a base spec ignores the control
    keys)."""
    return spec.prepare_latents(vae=vae, image=sample.get("image"), video=sample.get("video"),
                                control_image=sample.get("control_image"),
                                control_video=sample.get("control_video"), compute_posterior=False)


def _export(args, spec, transformer, state: Dict[str, Any]) -> None:
    """After each save of `state`: the adapter (its LoRA factors) to
    `output_dir/lora_weights/<step>` with, under `control-lora`, the trained
    non-LoRA weights beside it, or for full-rank training the transformer to
    `output_dir/model_weights/<step>` (JAX :386-415)."""
    step = state["train_state"]["step"]
    if args.training_type in LORA_TRAINING_TYPES:
        lora_dir = os.path.join(args.output_dir, "lora_weights", f"{step:06d}")
        lora_config = {"r": args.rank, "lora_alpha": args.lora_alpha, "target_modules": args.target_modules}
        lora_state = {name: value for name, value in state["trainable"].items() if ".lora_" in name}
        spec._save_lora_weights(lora_dir, lora_state, lora_config)
        save_control_aux_weights(lora_dir, spec, state["trainable"])
    else:
        spec._save_model(os.path.join(args.output_dir, "model_weights", f"{step:06d}"), transformer)


def _latest_export(root: str) -> Optional[str]:
    """The newest step-named subdirectory of an export root (e.g. lora_weights/000010)."""
    p = pathlib.Path(root)
    if not p.is_dir():
        return None
    steps = sorted((d for d in p.iterdir() if d.is_dir() and d.name.isdigit()), key=lambda d: int(d.name))
    return str(steps[-1]) if steps else None


def _jsonable(obj):
    """Nested dicts and lists of numbers and strings (numpy scalars, tuples and
    other values converted), as a checkpoint or a tracker's config holds them."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return str(obj)
