"""The port's inference runner (port of `examples/inference/inference.py`):
load a family's models, optionally an exported LoRA adapter, and generate one
video (or image) per request, written under `--output_dir`.

    python -m finetrainers_tpu_torch.inference --model_name wan \
        --pretrained_model_name_or_path <dir> --inference_type image_to_video \
        --image_path first_frame.png --prompt "a cat" --num_frames 81 --height 480 --width 832 \
        --lora_weights <output_dir>/lora_weights/<step>

The parser has every flag and default of the JAX runner's, plus the port's
`--device` (`cuda`, the default, or `cpu`). The scheduler is the one that
`<pretrained_model_name_or_path>/scheduler/scheduler_config.json` names (Wan
2.1 checkpoints name UniPC), else the family's default. Requests come from
`--prompt` (with `--image_path` for image-to-video) or from `--dataset_file`
(JSON, JSONL or CSV rows of prompt/image_path/...). `--attn_provider` runs the
denoise loop under that attention provider (`sage` reaches the int8 kernel).
`--quantize_int8` stores the transformer's base weights as int8 codes
with per-output-channel scales after the adapter is applied (its factors
stay as they are), so its linear layers run on int8 GEMMs. A flag whose
feature the port lacks raises NotImplementedError naming its ROADMAP.md item
when it is not at its default: parallel degrees above 1 and `.parquet`
request files. A control checkpoint (`--training_type control-lora` or
`control-full-finetune`) is served as JAX serves it (:181-187): the model
widened to 2x the latent channels, the adapter's
`control_aux_weights.safetensors` loaded with it, and `--control_image_path`
or `--control_video_path` (or the request file's columns) as the control;
there is no frame-conditioning flag, so the spec's default `full` applies
(ROADMAP.md section 3). With `--frame_conditioning_concatenate_mask` JAX
widens the model to 3x but its pipeline joins no mask channel, so the
request cannot run; the port refuses it before loading anything. `main(argv, **spec_kwargs)` returns the written
paths; keyword arguments go to the model specification, as `train.main`'s do.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .args import DTYPES, TOWER_FLAGS
from .config import get_model_specification_cls
from .logging import get_logger

logger = get_logger(__name__)


class InferenceType:
    T2V = "text_to_video"
    T2I = "text_to_image"
    I2V = "image_to_video"
    CHOICES = (T2V, T2I, I2V)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Every flag and default of JAX `examples/inference/inference.py:52-120`, and `--device`."""
    parser = argparse.ArgumentParser(description="finetrainers_tpu_torch inference runner")
    g = parser.add_argument_group("model")
    g.add_argument("--model_name", type=str, required=True)
    g.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    g.add_argument("--revision", type=str, default=None)
    g.add_argument("--cache_dir", type=str, default=None)
    for comp in ("tokenizer", "tokenizer_2", "tokenizer_3", "text_encoder",
                 "text_encoder_2", "text_encoder_3", "transformer", "vae"):
        g.add_argument(f"--{comp}_id", type=str, default=None)
    for comp in ("text_encoder", "text_encoder_2", "text_encoder_3", "transformer", "vae"):
        g.add_argument(f"--{comp}_dtype", type=str, default="bf16", choices=["fp32", "fp16", "bf16"])
    g.add_argument("--enable_slicing", action="store_true")
    g.add_argument("--enable_tiling", action="store_true")
    g.add_argument("--quantize_int8", action="store_true",
                   help="int8 storage of the transformer's base weights (per-output-channel scales), run on int8 "
                        "GEMMs; the LoRA factors stay as they are")
    g.add_argument("--lora_weights", type=str, default=None,
                   help="Directory or safetensors file of exported LoRA weights")
    g.add_argument("--lora_scale", type=float, default=1.0)
    g.add_argument("--training_type", type=str, default="lora",
                   choices=["lora", "full-finetune", "control-lora", "control-full-finetune"],
                   help="Spec flavor the weights were trained with")
    g.add_argument("--frame_conditioning_concatenate_mask", action="store_true",
                   help="Control checkpoints trained with the concatenated mask channel")
    g = parser.add_argument_group("inference")
    g.add_argument("--inference_type", type=str, default=InferenceType.T2V, choices=list(InferenceType.CHOICES))
    g.add_argument("--dataset_file", type=str, default=None,
                   help="CSV/JSON/JSONL file of generation requests")
    g.add_argument("--prompt", type=str, default=None)
    g.add_argument("--negative_prompt", type=str, default=None)
    g.add_argument("--image_path", type=str, default=None)
    g.add_argument("--control_image_path", type=str, default=None)
    g.add_argument("--control_video_path", type=str, default=None)
    g.add_argument("--height", type=int, default=512)
    g.add_argument("--width", type=int, default=704)
    g.add_argument("--num_frames", type=int, default=49)
    g.add_argument("--frame_rate", type=int, default=25)
    g.add_argument("--num_inference_steps", type=int, default=50)
    g.add_argument("--guidance_scale", type=float, default=5.0)
    g.add_argument("--num_videos_per_prompt", type=int, default=1)
    g = parser.add_argument_group("parallel")
    g.add_argument("--parallel_backend", type=str, default="ptd", choices=["accelerate", "ptd"])
    g.add_argument("--pp_degree", type=int, default=1)
    g.add_argument("--dp_degree", type=int, default=1)
    g.add_argument("--dp_shards", type=int, default=1)
    g.add_argument("--cp_degree", type=int, default=1)
    g.add_argument("--tp_degree", type=int, default=1)
    g = parser.add_argument_group("attention")
    g.add_argument("--attn_provider", type=str, default=None,
                   help="Attention provider for the denoise loop (sage int8, flash, ...)")
    g = parser.add_argument_group("misc")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--output_dir", type=str, default="finetrainers-inference")
    g.add_argument("--tracker_name", type=str, default="finetrainers-inference")
    g.add_argument("--report_to", type=str, default="none", choices=["none", "wandb", "jsonl"])
    g.add_argument("--verbose", type=int, default=0, choices=[0, 1, 2, 3])
    g.add_argument("--device", type=str, default="cuda", help="where the models live and run: cuda (default) or cpu")
    return parser.parse_args(argv)


# (flags, their default, the ROADMAP.md item of their feature)
_UNPORTED = (
    (("pp_degree", "dp_degree", "dp_shards", "cp_degree", "tp_degree"), 1, "queue 1 item 10 (parallel)"),
    (("revision", "cache_dir"), None, "queue 1 item 5 (loading diffusers checkpoints)"),
    (("tokenizer_id", "tokenizer_2_id", "tokenizer_3_id", "text_encoder_2_id", "text_encoder_3_id"), None,
     "queue 1 item 7 (the text towers)"),
)


def _check_ported(args: argparse.Namespace) -> None:
    lifted = TOWER_FLAGS.get(args.model_name, ())
    for flags, default, item in _UNPORTED:
        for flag in flags:
            if flag not in lifted and getattr(args, flag) != default:
                raise NotImplementedError(f"--{flag} {getattr(args, flag)!r} is not ported yet; see ROADMAP.md {item}")
    if args.training_type.startswith("control") and args.frame_conditioning_concatenate_mask:
        raise ValueError("--frame_conditioning_concatenate_mask: the runner widens the model to 3x the latent "
                         "channels, but the pipeline joins no mask channel (the spec's flag stays unset), so "
                         "no request can run, as in JAX; see ROADMAP.md section 3 finding 16")
    if args.dataset_file and pathlib.Path(args.dataset_file).suffix.lower() in (".parquet", ".arrow"):
        raise NotImplementedError(f"{args.dataset_file}: .parquet/.arrow request files need pandas and pyarrow, "
                                  "which the port does not use; see ROADMAP.md queue 1 item 2 (the data stage)")


class Inference:
    """The JAX runner's lifecycle (its `Inference`, :126-312): load the models,
    apply the adapter, build the pipeline, run each request, write its output."""

    def __init__(self, args: argparse.Namespace, **spec_kwargs) -> None:
        from .trackers import initialize_trackers

        _check_ported(args)
        self.args = args
        spec_cls = get_model_specification_cls(args.model_name, args.training_type)
        self.spec = spec_cls(
            pretrained_model_name_or_path=args.pretrained_model_name_or_path,
            text_encoder_id=args.text_encoder_id,
            text_encoder_2_id=args.text_encoder_2_id,
            tokenizer_id=args.tokenizer_id,
            tokenizer_2_id=args.tokenizer_2_id,
            transformer_id=args.transformer_id,
            vae_id=args.vae_id,
            text_encoder_dtype=DTYPES[args.text_encoder_dtype],
            text_encoder_2_dtype=DTYPES[args.text_encoder_2_dtype],
            transformer_dtype=DTYPES[args.transformer_dtype],
            vae_dtype=DTYPES[args.vae_dtype],
            device=args.device,
            **spec_kwargs,
        )
        self.spec.check_serving_text_encoders()  # before any model loads (ROADMAP.md section 3 finding 14)
        self.tracker = initialize_trackers(args.report_to, args.tracker_name,
                                           log_dir=os.path.join(args.output_dir, "logs"))
        self.pipeline = None

    def prepare_models(self) -> None:
        """The transformer (with the adapter's LoRA factors at its rank and
        alpha, `--lora_scale` folded into the B factors), the VAE and the
        pipeline (JAX :167-230)."""
        from .lora import (AUX_WEIGHTS_NAME, apply_auxiliary_weights, apply_lora_to_module_params,
                           load_lora_weights, scale_lora_b)

        args, spec = self.args, self.spec
        if args.lora_weights:
            state, config = load_lora_weights(args.lora_weights)
            rank = int(config.get("r", 0) or 0)
            if rank and getattr(spec, "lora_rank", 0) != rank:
                spec.lora_rank = rank
                spec.lora_alpha = float(config.get("lora_alpha", rank))
        if args.training_type.startswith("control"):
            base = spec.transformer_config["in_channels"]
            transformer = spec.load_diffusion_models(new_in_features=2 * base)["transformer"]
        else:
            transformer = spec.load_diffusion_models()["transformer"]
        if args.lora_weights:
            if args.lora_scale != 1.0:
                state = scale_lora_b(state, args.lora_scale)
            apply_lora_to_module_params(transformer.module, state, key_map=getattr(spec, "transformer_key_map", None))
            lora_dir = args.lora_weights if os.path.isdir(args.lora_weights) else os.path.dirname(args.lora_weights)
            apply_auxiliary_weights(transformer.module, os.path.join(lora_dir, AUX_WEIGHTS_NAME),
                                    key_map=getattr(spec, "transformer_key_map", None))
            logger.info(f"Loaded LoRA from {args.lora_weights} ({len(state)} tensors)")
        if args.quantize_int8:
            # JAX :217-228: the base weights' codes and scales, the adapter's factors kept as they are.
            from .utils.int8 import apply_int8_storage, count_int8_bytes

            transformer.module.requires_grad_(False)
            apply_int8_storage(transformer.module)
            logger.info(f"Quantized {count_int8_bytes(transformer.module):,} bytes of transformer base weights to "
                        "int8 (the LoRA factors stay as they are)")
        vae = spec.load_latent_models()["vae"]
        if args.enable_slicing:
            vae.enable_slicing()
        if args.enable_tiling:
            vae.enable_tiling()
        self.pipeline = spec.load_pipeline(transformer=transformer, vae=vae)

    def _requests(self) -> Iterator[Tuple[int, Dict[str, Any]]]:
        """(index, request kwargs): the rows of `--dataset_file`, or the one
        request of `--prompt` (and `--image_path` and `--control_image_path`,
        loaded as uint8 (H, W, 3), and `--control_video_path` as uint8 (F, H,
        W, 3); JAX :234-261)."""
        from .data import ValidationDataset
        from .data.utils import load_image

        args = self.args
        if args.dataset_file:
            for i, sample in enumerate(ValidationDataset(args.dataset_file)):
                yield i, {k: v for k, v in sample.items() if v is not None}
            return
        if args.prompt is None:
            raise ValueError("Provide --prompt or --dataset_file")
        request: Dict[str, Any] = dict(prompt=args.prompt)
        if args.negative_prompt:
            request["negative_prompt"] = args.negative_prompt
        if args.image_path:
            request["image"] = load_image(args.image_path, to_float=False)
        if args.control_image_path:
            request["control_image"] = load_image(args.control_image_path, to_float=False)
        if args.control_video_path:
            from .data.utils import load_video

            request["control_video"] = load_video(args.control_video_path, to_float=False)
        yield 0, request

    def run(self) -> List[str]:
        """Load the models, run every request, write each output and the
        manifest under `--output_dir` -> the written paths."""
        from .data.utils import save_image, save_video
        from .ops import attention_provider

        args = self.args
        self.prepare_models()
        out_dir = pathlib.Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        defaults: Dict[str, Any] = dict(height=args.height, width=args.width,
                                        num_inference_steps=args.num_inference_steps,
                                        guidance_scale=args.guidance_scale, seed=args.seed)
        if args.inference_type != InferenceType.T2I:
            defaults.update(num_frames=args.num_frames, frame_rate=args.frame_rate)
        ctx = attention_provider(args.attn_provider) if args.attn_provider else contextlib.nullcontext()
        artifacts: List[Dict[str, Any]] = []
        with ctx:
            for idx, sample in self._requests():
                if args.inference_type == InferenceType.I2V and "image" not in sample:
                    raise ValueError("image_to_video requests need image/--image_path")
                kwargs = {**defaults, **sample}
                for rep in range(max(args.num_videos_per_prompt, 1)):
                    kwargs["seed"] = args.seed + rep
                    t0 = time.perf_counter()
                    output = self.pipeline(**kwargs)
                    elapsed = time.perf_counter() - t0
                    stem = f"output-0-{idx:04d}-{rep}"
                    if output.ndim == 4:  # (F, H, W, 3) video
                        path, kind = out_dir / f"{stem}.mp4", "video"
                        save_video(output, str(path))
                    else:
                        path, kind = out_dir / f"{stem}.png", "image"
                        save_image(output, str(path))
                    artifacts.append({"type": kind, "path": str(path), "caption": sample.get("prompt")})
                    logger.info(f"[{idx}:{rep}] {kind} in {elapsed:.1f}s -> {path}")
                    self.tracker.log({"inference/seconds": elapsed}, step=len(artifacts))
        self.tracker.log_artifacts(artifacts, step=len(artifacts))
        self.tracker.finish()
        (out_dir / f"manifest-{os.getpid()}.json").write_text(json.dumps(artifacts, indent=2))
        return [a["path"] for a in artifacts]


def main(argv: Optional[List[str]] = None, **spec_kwargs) -> List[str]:
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    paths = Inference(args, **spec_kwargs).run()
    if paths:
        print(f"Saved {len(paths)} outputs under {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
