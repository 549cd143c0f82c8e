"""Training arguments and the command line (port of `finetrainers_tpu/args.py`,
with `SFTLowRankConfig` of `trainer/sft_trainer/config.py` and
`AttentionProviderArgs`).

`BaseArgs` is a dataclass with every field of the JAX package's `BaseArgs` and
its defaults (dtypes are torch dtypes), the LoRA fields and the two
provider mappings, so a caller may set fields directly. `parse_args` builds
the same parser as the JAX package: its 96 flags with `--list_models`,
`--attn_provider_training`/`--attn_provider_inference` as `module:provider`
lists, `--rank`, `--lora_alpha` and `--target_modules` for the LoRA
training types, and the control trainer's flags (`--control_type`,
`--train_qk_norm`, `--frame_conditioning_*`) for the control types. One flag
is the port's own: `--device` (default `cuda`).

A flag whose feature the port lacks raises NotImplementedError naming its
ROADMAP.md item when it is given a value other than its default
(`check_ported`, which the trainer also runs); none is ignored in silence.
On one card `--parallel_backend` selects nothing and is accepted as it is.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
from typing import Any, Dict, List, Optional

import torch

# Providers the CLI accepts for training, and in addition for inference (the
# int8 sage names are forward-only), as the JAX package's lists.
AttentionProviderTraining = [
    "auto", "flash", "splash", "tpu_flash", "flash_varlen", "flex", "ring", "ulysses",
    "native", "xla", "xformers", "_native_cudnn", "_native_efficient",
    "_native_flash", "_native_math",
]
AttentionProviderValidation = AttentionProviderTraining + [
    "sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda",
    "_sage_qk_int8_pv_fp16_triton", "_sage_qk_int8_pv_fp8_cuda",
    "_sage_qk_int8_pv_fp8_cuda_sm90",
]

DTYPES = {
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "fp32": torch.float32,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
}

DEFAULT_TARGET_MODULES = "(transformer_blocks|blocks).*(to_q|to_k|to_v|to_out)"
DEFAULT_SKIP_MODULES_PATTERN = ["patch_embed", "pos_embed", "x_embedder", "context_embedder", "time_embed",
                                "^proj_in$", "^proj_out$", "norm"]
LORA_TRAINING_TYPES = ("lora", "control-lora")
CONTROL_TRAINING_TYPES = ("control-lora", "control-full-finetune")


@dataclasses.dataclass
class BaseArgs:
    # Parallel
    parallel_backend: str = "jax"
    pp_degree: int = 1
    pp_microbatches: int = 0
    dp_degree: int = 1
    dp_shards: int = 1
    cp_degree: int = 1
    tp_degree: int = 1
    # Model
    model_name: Optional[str] = None
    pretrained_model_name_or_path: Optional[str] = None
    revision: Optional[str] = None
    variant: Optional[str] = None
    cache_dir: Optional[str] = None
    tokenizer_id: Optional[str] = None
    tokenizer_2_id: Optional[str] = None
    tokenizer_3_id: Optional[str] = None
    text_encoder_id: Optional[str] = None
    text_encoder_2_id: Optional[str] = None
    text_encoder_3_id: Optional[str] = None
    transformer_id: Optional[str] = None
    vae_id: Optional[str] = None
    text_encoder_dtype: torch.dtype = torch.bfloat16
    text_encoder_2_dtype: torch.dtype = torch.bfloat16
    text_encoder_3_dtype: torch.dtype = torch.bfloat16
    transformer_dtype: torch.dtype = torch.bfloat16
    vae_dtype: torch.dtype = torch.bfloat16
    layerwise_upcasting_modules: List[str] = dataclasses.field(default_factory=list)
    layerwise_upcasting_storage_dtype: torch.dtype = torch.float8_e4m3fn
    layerwise_upcasting_skip_modules_pattern: List[str] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_SKIP_MODULES_PATTERN))
    # Training type
    training_type: Optional[str] = None
    # LoRA (SFTLowRankConfig). `target_modules` is written into the exported
    # adapter's metadata; every LoRA factor trains, as in the JAX trainer.
    rank: int = 64
    lora_alpha: int = 64
    target_modules: str = DEFAULT_TARGET_MODULES
    # Control training (ControlLowRankConfig / ControlFullRankConfig), with the parser's defaults.
    control_type: str = "canny"
    train_qk_norm: bool = False
    frame_conditioning_type: str = "index"
    frame_conditioning_index: int = 0
    frame_conditioning_concatenate_mask: bool = False
    # Attention providers, per module: "module:provider" or "provider" (transformer)
    attn_provider_training: List[str] = dataclasses.field(default_factory=list)
    attn_provider_inference: List[str] = dataclasses.field(default_factory=list)
    # Dataset
    dataset_config: Optional[str] = None
    dataset_shuffle_buffer_size: int = 1
    enable_precomputation: bool = False
    precomputation_items: int = 512
    precomputation_dir: Optional[str] = None
    precomputation_once: bool = False
    precomputation_reuse: bool = False
    # Dataloader
    dataloader_num_workers: int = 0
    pin_memory: bool = False
    # Diffusion
    flow_resolution_shifting: bool = False
    flow_base_seq_len: int = 256
    flow_max_seq_len: int = 4096
    flow_base_shift: float = 0.5
    flow_max_shift: float = 1.15
    flow_shift: float = 1.0
    flow_weighting_scheme: str = "none"
    flow_logit_mean: float = 0.0
    flow_logit_std: float = 1.0
    flow_mode_scale: float = 1.29
    # Training
    seed: Optional[int] = None
    batch_size: int = 1
    train_steps: int = 1000
    max_data_samples: int = 2**64
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    gradient_checkpointing_type: str = "full"
    steps_per_dispatch: int = 1
    # Checkpoints (`output_dir/checkpoints/finetrainers_step_<step>`) and exports (`output_dir/lora_weights/`)
    checkpointing_steps: int = 500
    checkpointing_limit: Optional[int] = None
    checkpoint_on_preemption: bool = False
    resume_from_checkpoint: Optional[str] = None  # "latest" or a step
    enable_slicing: bool = False
    enable_tiling: bool = False
    # Optimizer
    optimizer: str = "adamw"
    lr: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    lr_num_cycles: int = 1
    lr_power: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.95
    beta3: Optional[float] = None
    weight_decay: float = 1e-4
    epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    # Validation
    validation_dataset_file: Optional[str] = None
    validation_steps: int = 500
    enable_model_cpu_offload: bool = False
    # Miscellaneous
    tracker_name: str = "finetrainers"
    push_to_hub: bool = False
    hub_token: Optional[str] = None
    hub_model_id: Optional[str] = None
    output_dir: str = "finetrainers-training"
    logging_dir: str = "logs"
    logging_steps: int = 1
    init_timeout: int = 300
    nccl_timeout: int = 600
    report_to: str = "none"
    verbose: int = 0
    # Performance and debugging
    compile_modules: List[str] = dataclasses.field(default_factory=list)
    compile_scopes: Optional[List[str]] = None
    allow_tf32: bool = False
    float32_matmul_precision: str = "highest"
    enable_profiling: bool = False
    profiling_start_step: int = 2
    profiling_num_steps: int = 3
    # The port's own: where the models live and train ("cuda" or "cpu").
    device: str = "cuda"

    def parse_args(self, argv: Optional[List[str]] = None) -> "BaseArgs":
        """Parse `argv` (default `sys.argv[1:]`) into this object and check it.
        `--list_models` prints the registry and exits."""
        argv = list(sys.argv[1:] if argv is None else argv)
        if "--list_models" in argv:
            _print_models()
            sys.exit(0)
        training_type = argv[argv.index("--training_type") + 1] if "--training_type" in argv else None
        namespace = build_parser(training_type).parse_args(argv)
        for key, value in vars(namespace).items():
            if key == "list_models":
                continue
            if key.endswith("_dtype"):
                value = DTYPES[value]
            elif key == "target_modules":
                value = value if isinstance(value, str) else "|".join(value)
            elif key.startswith("attn_provider_"):
                value = value or []
            setattr(self, key, value)
        _validate_args(self)
        return self

    def check_ported(self) -> None:
        """Raise NotImplementedError for a flag whose feature the port lacks and
        that holds a value other than its default."""
        defaults = BaseArgs()
        lifted = TOWER_FLAGS.get(self.model_name, ())
        for names, item in _UNPORTED:
            for name in names:
                if name not in lifted and getattr(self, name) != getattr(defaults, name):
                    raise NotImplementedError(
                        f"--{name}={getattr(self, name)!r}: not ported to PyTorch yet; see ROADMAP.md {item}")

    def to_dict(self) -> Dict[str, Any]:
        """The fields grouped as the JAX package's `to_dict` groups them (for
        the tracker's config), dtypes by name."""
        names = {dtype: name for name, dtype in DTYPES.items()}
        flat = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        flat = {k: names.get(v, v) if isinstance(v, torch.dtype) else v for k, v in flat.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for group, keys in _GROUPS.items():
            out[group] = {k: flat.pop(k) for k in keys}
        out["extra_arguments"] = flat
        return out


# The tower flags each family's spec reads since its text towers load from a
# local checkpoint (CogView4's GLM; HunyuanVideo's Llama and CLIP text; Flux's
# CLIP text and T5; Wan's UMT5, LTX-Video's and CogVideoX's T5); for every
# other family they stay refused below.
TOWER_FLAGS = {"cogview4": ("tokenizer_id",),
               "hunyuan_video": ("tokenizer_id", "tokenizer_2_id", "text_encoder_2_id"),
               "flux": ("tokenizer_id", "tokenizer_2_id", "text_encoder_2_id"),
               "wan": ("tokenizer_id",),
               "ltx_video": ("tokenizer_id",),
               "cogvideox": ("tokenizer_id",)}

# (flags, the ROADMAP.md item of their feature)
_UNPORTED = (
    (("pp_degree", "pp_microbatches", "dp_degree", "dp_shards", "cp_degree", "tp_degree", "init_timeout",
      "nccl_timeout"), "queue 1 item 10 (parallel)"),
    (("revision", "variant", "cache_dir"), "queue 1 item 5 (loading diffusers checkpoints)"),
    (("tokenizer_id", "tokenizer_2_id", "tokenizer_3_id", "text_encoder_2_id", "text_encoder_3_id"),
     "queue 1 item 7 (the text towers)"),
    (("steps_per_dispatch", "compile_modules", "compile_scopes"), "queue 1 item 3 (the work XLA fused)"),
    (("precomputation_reuse", "flow_resolution_shifting", "flow_base_seq_len", "flow_max_seq_len", "flow_base_shift",
      "flow_max_shift", "beta3", "enable_model_cpu_offload"),
     "queue 1 item 11 (flags the JAX trainer parses but never reads)"),
    (("push_to_hub", "hub_token", "hub_model_id"), "queue 1 item 11 (the Hub push; it needs the network)"),
)

_GROUPS = {
    "parallel_arguments": ("parallel_backend", "pp_degree", "pp_microbatches", "dp_degree", "dp_shards", "cp_degree",
                           "tp_degree"),
    "model_arguments": ("model_name", "pretrained_model_name_or_path", "revision", "variant", "cache_dir",
                        "tokenizer_id", "tokenizer_2_id", "tokenizer_3_id", "text_encoder_id", "text_encoder_2_id",
                        "text_encoder_3_id", "transformer_id", "vae_id", "text_encoder_dtype", "text_encoder_2_dtype",
                        "text_encoder_3_dtype", "transformer_dtype", "vae_dtype", "layerwise_upcasting_modules",
                        "layerwise_upcasting_storage_dtype"),
    "dataset_arguments": ("dataset_config", "dataset_shuffle_buffer_size", "enable_precomputation",
                          "precomputation_items", "precomputation_dir", "precomputation_once", "precomputation_reuse"),
    "dataloader_arguments": ("dataloader_num_workers", "pin_memory"),
    "diffusion_arguments": ("flow_resolution_shifting", "flow_base_seq_len", "flow_max_seq_len", "flow_base_shift",
                            "flow_max_shift", "flow_shift", "flow_weighting_scheme", "flow_logit_mean",
                            "flow_logit_std", "flow_mode_scale"),
    "training_arguments": ("training_type", "seed", "batch_size", "train_steps", "max_data_samples",
                           "gradient_accumulation_steps", "gradient_checkpointing", "gradient_checkpointing_type",
                           "steps_per_dispatch", "checkpointing_steps", "checkpointing_limit",
                           "checkpoint_on_preemption", "resume_from_checkpoint", "enable_slicing", "enable_tiling"),
    "optimizer_arguments": ("optimizer", "lr", "lr_scheduler", "lr_warmup_steps", "lr_num_cycles", "lr_power",
                            "beta1", "beta2", "beta3", "weight_decay", "epsilon", "max_grad_norm"),
    "validation_arguments": ("validation_dataset_file", "validation_steps", "enable_model_cpu_offload"),
    "miscellaneous_arguments": ("tracker_name", "push_to_hub", "hub_token", "hub_model_id", "output_dir",
                                "logging_dir", "logging_steps", "init_timeout", "nccl_timeout", "report_to", "verbose"),
}


def build_parser(training_type: Optional[str] = None) -> argparse.ArgumentParser:
    """The JAX package's parser (copied from `finetrainers_tpu/args.py:354-462`),
    its provider flags, the flags `training_type` registers (JAX `train.py:42-61`:
    the LoRA flags, and the control trainer's), and `--device`."""
    parser = argparse.ArgumentParser()
    add = parser.add_argument
    # Parallel
    add("--parallel_backend", type=str, default="jax", choices=["jax", "ptd", "accelerate"])
    for name in ("pp_degree", "dp_degree", "dp_shards", "cp_degree", "tp_degree"):
        add(f"--{name}", type=int, default=1)
    add("--pp_microbatches", type=int, default=0)
    # Model
    add("--model_name", type=str, required=False)
    add("--pretrained_model_name_or_path", type=str, required=True)
    for name in ("revision", "variant", "cache_dir", "tokenizer_id", "tokenizer_2_id", "tokenizer_3_id",
                 "text_encoder_id", "text_encoder_2_id", "text_encoder_3_id", "transformer_id", "vae_id"):
        add(f"--{name}", type=str, default=None)
    for name in ("text_encoder_dtype", "text_encoder_2_dtype", "text_encoder_3_dtype", "transformer_dtype",
                 "vae_dtype"):
        add(f"--{name}", type=str, default="bf16")
    add("--layerwise_upcasting_modules", type=str, default=[], nargs="+", choices=["transformer"])
    add("--layerwise_upcasting_storage_dtype", type=str, default="float8_e4m3fn",
        choices=["float8_e4m3fn", "float8_e5m2", "int8"])
    add("--layerwise_upcasting_skip_modules_pattern", type=str, default=list(DEFAULT_SKIP_MODULES_PATTERN),
        nargs="+")
    add("--training_type", type=str, default=None)
    # Dataset
    add("--dataset_config", type=str, required=True)
    add("--dataset_shuffle_buffer_size", type=int, default=1)
    add("--enable_precomputation", action="store_true")
    add("--precomputation_items", type=int, default=512)
    add("--precomputation_dir", type=str, default=None)
    add("--precomputation_once", action="store_true")
    add("--precomputation_reuse", action="store_true")
    # Dataloader
    add("--dataloader_num_workers", type=int, default=0)
    add("--pin_memory", action="store_true")
    # Diffusion
    add("--flow_resolution_shifting", action="store_true")
    add("--flow_base_seq_len", type=int, default=256)
    add("--flow_max_seq_len", type=int, default=4096)
    add("--flow_base_shift", type=float, default=0.5)
    add("--flow_max_shift", type=float, default=1.15)
    add("--flow_shift", type=float, default=1.0)
    add("--flow_weighting_scheme", type=str, default="none",
        choices=["sigma_sqrt", "logit_normal", "mode", "cosmap", "none"])
    add("--flow_logit_mean", type=float, default=0.0)
    add("--flow_logit_std", type=float, default=1.0)
    add("--flow_mode_scale", type=float, default=1.29)
    # Training
    add("--seed", type=int, default=None)
    add("--batch_size", type=int, default=1)
    add("--train_steps", type=int, default=1000)
    add("--max_data_samples", type=int, default=2**64)
    add("--gradient_accumulation_steps", type=int, default=1)
    add("--gradient_checkpointing", action="store_true")
    add("--gradient_checkpointing_type", type=str, default="full",
        choices=["full", "ops", "ops_attn", "ops_narrow", "block_skip"])
    add("--steps_per_dispatch", type=int, default=1)
    add("--checkpointing_steps", type=int, default=500)
    add("--checkpointing_limit", type=int, default=None)
    add("--checkpoint_on_preemption", action="store_true")
    add("--resume_from_checkpoint", type=str, default=None)
    add("--enable_slicing", action="store_true")
    add("--enable_tiling", action="store_true")
    # Optimizer
    add("--optimizer", type=str, default="adamw", choices=["adam", "adamw", "adam-bnb-8bit", "adamw-bnb-8bit"])
    add("--lr", type=float, default=1e-4)
    add("--lr_scheduler", type=str, default="constant")
    add("--lr_warmup_steps", type=int, default=500)
    add("--lr_num_cycles", type=int, default=1)
    add("--lr_power", type=float, default=1.0)
    add("--beta1", type=float, default=0.9)
    add("--beta2", type=float, default=0.95)
    add("--beta3", type=float, default=None)
    add("--weight_decay", type=float, default=1e-04)
    add("--epsilon", type=float, default=1e-8)
    add("--max_grad_norm", default=1.0, type=float)
    # Validation
    add("--validation_dataset_file", type=str, default=None)
    add("--validation_steps", type=int, default=500)
    add("--enable_model_cpu_offload", action="store_true")
    # Miscellaneous
    add("--tracker_name", type=str, default="finetrainers")
    add("--push_to_hub", action="store_true")
    add("--hub_token", type=str, default=None)
    add("--hub_model_id", type=str, default=None)
    add("--output_dir", type=str, default="finetrainers-training")
    add("--logging_dir", type=str, default="logs")
    add("--logging_steps", type=int, default=1)
    add("--init_timeout", type=int, default=300)
    add("--nccl_timeout", type=int, default=600)
    add("--report_to", type=str, default="none", choices=["none", "wandb", "jsonl"])
    add("--verbose", type=int, default=0, choices=[0, 1, 2, 3])
    # Performance and debugging
    add("--compile_modules", type=str, default=[], nargs="+")
    add("--compile_scopes", type=str, default=None, nargs="+")
    add("--allow_tf32", action="store_true")
    add("--float32_matmul_precision", type=str, default="highest", choices=["highest", "high", "medium"])
    add("--enable_profiling", action="store_true", help="Write a torch.profiler trace of a few steps")
    add("--profiling_start_step", type=int, default=2)
    add("--profiling_num_steps", type=int, default=3)
    add("--list_models", action="store_true")
    # Attention providers
    add("--attn_provider_training", type=str, default=None, nargs="+")
    add("--attn_provider_inference", type=str, default=None, nargs="+")
    if training_type == "lora":
        add("--rank", type=int, default=64)
        add("--lora_alpha", type=int, default=64)
        add("--target_modules", type=str, nargs="+", default=[DEFAULT_TARGET_MODULES])
    elif training_type in CONTROL_TRAINING_TYPES:
        from .trainer.control_trainer.config import ControlFullRankConfig, ControlLowRankConfig

        (ControlLowRankConfig() if training_type == "control-lora" else ControlFullRankConfig()).add_args(parser)
    add("--device", type=str, default="cuda", help="where the models live and train: cuda (default) or cpu")
    return parser


def _validate_args(args: BaseArgs) -> None:
    if min(args.pp_degree, args.dp_degree, args.dp_shards, args.cp_degree, args.tp_degree) < 1:
        raise ValueError("Parallel degrees must be >= 1")
    if args.batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    if args.gradient_accumulation_steps < 1:
        raise ValueError("gradient_accumulation_steps must be >= 1")
    if args.train_steps < 1:
        raise ValueError("train_steps must be >= 1")
    if args.training_type in LORA_TRAINING_TYPES and args.rank < 1:
        raise ValueError("LoRA rank must be >= 1")
    if args.validation_dataset_file is not None:
        ext = pathlib.Path(args.validation_dataset_file).suffix
        if ext not in (".csv", ".json", ".jsonl", ".parquet", ".arrow"):
            raise ValueError("validation_dataset_file must be csv/json/jsonl/parquet/arrow")
    for entry in args.attn_provider_training:
        if entry.split(":")[-1] not in AttentionProviderTraining:
            raise ValueError(f"Attention provider {entry.split(':')[-1]!r} is not supported for training.")
    for entry in args.attn_provider_inference:
        if entry.split(":")[-1] not in AttentionProviderValidation:
            raise ValueError(f"Attention provider {entry.split(':')[-1]!r} is not supported for inference.")
    args.check_ported()


def _print_models() -> None:
    from .config import _REGISTRY

    print("Supported models:")
    for model_type, types in _REGISTRY.items():
        ported = sorted(t.value for t, ref in types.items() if ref is not None)
        missing = sorted(t.value for t, ref in types.items() if ref is None)
        print(f"  {model_type.value}: {ported}" + (f" (not ported yet: {missing})" if missing else ""))
