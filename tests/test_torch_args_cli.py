"""The port's command line against the JAX package's.

- `examples/training/sft/wan/crush_smol_lora/train.sh`'s argv, as bash expands
  it, parses into the same value for every field the two `BaseArgs` share
  (with the example's parallel layout replaced by one card's; dtypes by name),
  with JAX's `train.py` registration (`SFTLowRankConfig`,
  `AttentionProviderArgs`); the port also parses every default the same;
- CogView4's raider_white_tarot train.sh (int8 weight storage) parses as JAX
  parses it, and so do the storage and 8-bit optimizer flags;
- the example's own layout (FSDP x CP over 8 chips) and every other flag whose
  feature the port lacks raise NotImplementedError naming a ROADMAP.md item
  when given a value other than its default; none is ignored;
- `--list_models` prints the registry and exits 0; unknown flags, LoRA flags
  under full-rank training and a bad `--training_type` fail as in JAX;
- the LoRA target regex: every LoRA layer trains (as in the JAX trainer), and
  the trainer warns once where an explicit `--target_modules` selects fewer
  layers (train.sh's leaves the feed-forward layers out), not for the default.
"""

import logging
import os
import pathlib
import subprocess

import pytest
import torch

from finetrainers_tpu.args import AttentionProviderArgs as JaxAttentionArgs
from finetrainers_tpu.args import BaseArgs as JaxArgs
from finetrainers_tpu.trainer.control_trainer import ControlFullRankConfig, ControlLowRankConfig
from finetrainers_tpu.trainer.sft_trainer import SFTFullRankConfig, SFTLowRankConfig
from finetrainers_tpu_torch import get_model_specification_cls, train
from finetrainers_tpu_torch.args import DTYPES, BaseArgs
from finetrainers_tpu_torch.trainer import SFTTrainer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAIN_SH = REPO / "examples" / "training" / "sft" / "wan" / "crush_smol_lora" / "train.sh"
REQUIRED = ["--pretrained_model_name_or_path", "x", "--dataset_config", "d.json"]
TINY = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=1, ffn_dim=64, text_dim=32, freq_dim=16)


def _train_sh_argv(tmp_path, train_sh=TRAIN_SH):
    """The arguments train.sh passes to `python train.py`, expanded by bash."""
    script = 'python() { shift; printf "%s\\0" "$@"; }; source "$0"'
    res = subprocess.run(["bash", "-c", script, str(train_sh)], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "HOME": str(tmp_path)}, timeout=60)
    assert res.returncode == 0, res.stderr
    return res.stdout.split("\0")[:-1]


def _one_card(argv):
    argv = list(argv)
    for flag in ("--pp_degree", "--dp_degree", "--dp_shards", "--cp_degree", "--tp_degree"):
        argv[argv.index(flag) + 1] = "1"
    return argv


def _jax_args(argv, training_type="lora"):
    args = JaxArgs()
    args.register_args(JaxAttentionArgs())
    args.register_args({"lora": SFTLowRankConfig, "full-finetune": SFTFullRankConfig,
                        "control-lora": ControlLowRankConfig,
                        "control-full-finetune": ControlFullRankConfig}[training_type]())
    return args.parse_args(argv)


def _dtype_name(value):
    for name, dtype in DTYPES.items():
        if value == dtype:
            return name
    from finetrainers_tpu.args import _DTYPE_MAP

    for name, dtype in _DTYPE_MAP.items():
        if value == dtype:
            return name
    return value


def _assert_same_fields(ours, ref):
    shared = [name for name in vars(BaseArgs()) if name != "device" and hasattr(ref, name)]
    assert len(shared) >= 97, len(shared)  # 100 under LoRA training
    for name in shared:
        got, want = getattr(ours, name), getattr(ref, name)
        if isinstance(got, torch.dtype):
            got, want = _dtype_name(got), _dtype_name(want)
        assert got == want, (name, got, want)


def test_train_sh_parses_as_jax_parses_it(tmp_path):
    argv = _train_sh_argv(tmp_path)
    assert "--attn_provider_training" in argv and argv[argv.index("--cp_degree") + 1] == "2"
    ours = BaseArgs().parse_args(_one_card(argv))
    _assert_same_fields(ours, _jax_args(_one_card(argv)))
    assert ours.attn_provider_training == ["transformer:ring"] and ours.device == "cuda"
    assert ours.target_modules == "blocks.*(to_q|to_k|to_v|to_out.0)" and ours.transformer_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md queue 1 item 10"):
        BaseArgs().parse_args(argv)  # the example's 8-chip FSDP x CP layout


CONTROL_EXAMPLES = {"canny": ("cogview4", "canny", "transformer:auto"),
                    "image_condition": ("wan", "none", "transformer:ring")}


@pytest.mark.parametrize("example", sorted(CONTROL_EXAMPLES))
def test_control_train_sh_parses_as_jax_parses_it(example, tmp_path):
    """The control examples' train.sh (control-lora at rank 128, the control
    and frame-conditioning flags) parse into JAX's values with JAX's
    `ControlLowRankConfig` registration, on one card's layout."""
    model, control_type, provider = CONTROL_EXAMPLES[example]
    train_sh = REPO / "examples" / "training" / "control" / model / example / "train.sh"
    argv = _one_card(_train_sh_argv(tmp_path, train_sh))
    ours = BaseArgs().parse_args(argv)
    ref = _jax_args(argv, "control-lora")
    _assert_same_fields(ours, ref)
    for name in ("control_type", "train_qk_norm", "frame_conditioning_type", "frame_conditioning_index",
                 "frame_conditioning_concatenate_mask"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert (ours.model_name, ours.training_type, ours.rank, ours.lora_alpha) == (model, "control-lora", 128, 128)
    assert (ours.control_type, ours.attn_provider_training) == (control_type, [provider])
    assert (ours.frame_conditioning_type, ours.frame_conditioning_index) == ("index", 0)
    assert ours.gradient_checkpointing_type == "ops" and ours.enable_tiling and ours.precomputation_once


@pytest.mark.parametrize("training_type", ["control-lora", "control-full-finetune"])
def test_control_defaults_parse_as_jax(training_type):
    argv = REQUIRED + ["--training_type", training_type]
    ours, ref = BaseArgs().parse_args(argv), _jax_args(argv, training_type)
    _assert_same_fields(ours, ref)
    assert (ours.control_type, ours.frame_conditioning_type) == (ref.control_type, ref.frame_conditioning_type) == (
        "canny", "index")
    if training_type == "control-lora":
        assert (ours.rank, ours.lora_alpha, ours.target_modules) == (64, 64, ref.target_modules)


@pytest.mark.parametrize("training_type", ["lora", "full-finetune"])
def test_defaults_parse_as_jax(training_type):
    argv = REQUIRED + ["--training_type", training_type]
    _assert_same_fields(BaseArgs().parse_args(argv), _jax_args(argv, training_type))


@pytest.mark.parametrize("flags", [
    ["--steps_per_dispatch", "2"], ["--cp_degree", "2"], ["--dp_shards", "8"], ["--pp_degree", "2"],
    ["--pp_microbatches", "4"], ["--nccl_timeout", "60"], ["--compile_modules", "transformer"], ["--compile_scopes", "regional"], ["--precomputation_reuse"],
    ["--push_to_hub"], ["--hub_model_id", "me/model"], ["--tokenizer_id", "t5"], ["--revision", "main"],
    ["--cache_dir", "c"], ["--flow_resolution_shifting"], ["--beta3", "0.9"], ["--enable_model_cpu_offload"],
], ids=lambda flags: flags[0].lstrip("-"))
def test_unported_flag_raises_naming_its_roadmap_item(flags):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item \d+"):
        BaseArgs().parse_args(REQUIRED + ["--training_type", "lora"] + flags)
    _jax_args(REQUIRED + flags)  # the JAX package takes each of them


@pytest.mark.parametrize("flags", [
    ["--optimizer", "adamw-bnb-8bit"], ["--optimizer", "adam-bnb-8bit"],
    ["--layerwise_upcasting_modules", "transformer"], ["--layerwise_upcasting_storage_dtype", "int8"],
    ["--layerwise_upcasting_storage_dtype", "float8_e5m2"],
    ["--layerwise_upcasting_skip_modules_pattern", "norm", "^proj_out$"],
], ids=lambda flags: "_".join(f.lstrip("-") for f in flags[:2]))
def test_storage_and_8bit_optimizer_flags_parse_as_jax(flags):
    """Weight storage and the 8-bit optimizers are ported: their flags parse to JAX's values."""
    argv = REQUIRED + ["--training_type", "lora"] + flags
    _assert_same_fields(BaseArgs().parse_args(argv), _jax_args(argv, "lora"))


def test_raider_white_tarot_train_sh_parses_as_jax(tmp_path):
    """CogView4's raider_white_tarot SFT example: int8 storage of the
    transformer under LoRA rank 32, its flags as bash expands them, one card's
    layout; every field as JAX parses it."""
    train_sh = REPO / "examples" / "training" / "sft" / "cogview4" / "raider_white_tarot" / "train.sh"
    argv = _one_card(_train_sh_argv(tmp_path, train_sh))
    ours = BaseArgs().parse_args(argv)
    _assert_same_fields(ours, _jax_args(argv))
    assert ours.layerwise_upcasting_modules == ["transformer"] and ours.layerwise_upcasting_storage_dtype == torch.int8
    assert (ours.model_name, ours.rank, ours.gradient_checkpointing_type) == ("cogview4", 32, "ops")


def test_control_training_raises_and_list_models_exits(capsys):
    """The raises that remain: a family without a control specification
    refuses the control types, as JAX's registry does, and the control flags
    parse only under a control training type."""
    with pytest.raises(ValueError, match="not supported for model 'ltx_video'"):
        train.main(REQUIRED + ["--model_name", "ltx_video", "--training_type", "control-lora", "--device", "cpu"])
    with pytest.raises(SystemExit):
        BaseArgs().parse_args(REQUIRED + ["--training_type", "lora", "--control_type", "canny"])
    with pytest.raises(ValueError, match="--training_type"):
        train.main(REQUIRED + ["--model_name", "wan", "--training_type", "sft"])
    with pytest.raises(SystemExit) as exit_info:
        train.main(["--list_models"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    assert "wan: ['control-full-finetune', 'control-lora', 'full-finetune', 'lora']" in out and "ltx_video" in out
    with pytest.raises(SystemExit):
        BaseArgs().parse_args(REQUIRED + ["--training_type", "full-finetune", "--rank", "4"])
    with pytest.raises(SystemExit):
        BaseArgs().parse_args(REQUIRED + ["--no_such_flag"])
    with pytest.raises(ValueError, match="not supported for training"):
        BaseArgs().parse_args(REQUIRED + ["--attn_provider_training", "transformer:sage"])


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("regex,warns", [("blocks.*(to_q|to_k|to_v|to_out.0)", True), (None, False)],
                         ids=["train_sh", "default"])
def test_target_modules_warning(regex, warns):
    spec = get_model_specification_cls("wan", "lora")(device="cpu", transformer_config=TINY,
                                                      transformer_dtype=torch.float32)
    args = BaseArgs(training_type="lora", rank=4, lora_alpha=4, **({} if regex is None else {"target_modules": regex}))
    trainer = SFTTrainer(args, spec)
    records = _Records()
    logger = logging.getLogger("finetrainers_tpu_torch.trainer.sft_trainer.trainer")
    logger.addHandler(records)
    try:
        trainer.prepare()
    finally:
        logger.removeHandler(records)
    warnings = [m for m in records.messages if "--target_modules" in m]
    assert len(warnings) == int(warns), records.messages
    assert len(trainer._trainable) == 10 * 2  # every LoRA layer of the block trains, the feed-forward ones too
    if warns:
        trained = sum(p.numel() for p in trainer._trainable.values())
        attention = sum(p.numel() for n, p in trainer._trainable.items() if ".ffn." not in n)
        assert f"{trained:,} parameters trained against {attention:,} selected" in warnings[0]
