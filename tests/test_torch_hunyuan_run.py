"""The modal_labs_dissolve LoRA example through the port's command line
(`finetrainers_tpu_torch.train.main`) on a tiny HunyuanVideo model, from
videos the test writes with cv2.

The run takes `examples/training/sft/hunyuan_video/modal_labs_dissolve/train.sh`'s
flags as bash expands them (precompute once, a shuffle buffer of 10,
`transformer:ring`, "ops" remat, slicing and tiling, rank 32, the example's
AdamW, logit-normal weighting, the example's `--target_modules`), with one
card's layout and these cuts for the CPU: 4 videos of 7 frames written at
24x36 and bucketed to 5x16x24 (the example buckets to 49x480x768), 4 steps
with a checkpoint every 2, one validation request with 2 steps at the end,
the tiny spec (2 dual, 2 single and 2 refiner blocks, 2 heads of 64, a VAE of
8-16 channels with 2x spatial and 2x temporal compression), fp32, a JSONL
tracker. The run precomputes video moments (1, 8, 3, 8, 12) and 256-slot
text states, trains every LoRA layer, the refiner's too (the example's regex
selects fewer, so the trainer warns once), and writes its checkpoints,
adapters (whose keys are the model's LoRA factors), the validation videos as
.mp4 (from the live weights, then from the exported adapter in a fresh
model) and the model card tagged text-to-video.
"""

import csv
import json
import logging
import os
import pathlib
import subprocess

import cv2
import numpy as np
import pytest
import torch

from finetrainers_tpu_torch import train as train_cli
from finetrainers_tpu_torch.constants import PRECOMPUTED_DIR_NAME
from finetrainers_tpu_torch.data.utils import load_video
from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, load_lora_weights
from finetrainers_tpu_torch.models import autoencoders
from test_torch_hunyuan_pipeline import TINY, VAE_KW

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "training" / "sft" / "hunyuan_video" / "modal_labs_dissolve"
BUCKET = (5, 16, 24)
STEPS = 4


def _train_sh_argv(home):
    """The arguments train.sh passes to `python train.py`, expanded by bash, on one card."""
    script = 'python() { shift; printf "%s\\0" "$@"; }; source "$0"'
    res = subprocess.run(["bash", "-c", script, str(EXAMPLE / "train.sh")], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "HOME": str(home)}, timeout=60)
    assert res.returncode == 0, res.stderr
    argv = res.stdout.split("\0")[:-1]
    for flag in ("--pp_degree", "--dp_degree", "--dp_shards", "--cp_degree", "--tp_degree"):
        argv[argv.index(flag) + 1] = "1"
    return argv


def _set(argv, **flags):
    argv = list(argv)
    for flag, value in flags.items():
        if f"--{flag}" in argv:
            argv[argv.index(f"--{flag}") + 1] = str(value)
        else:
            argv += [f"--{flag}", str(value)]
    return argv


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("hunyuan_run")
    rng = np.random.RandomState(0)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(4):
            writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (36, 24))
            for _ in range(7):
                writer.write(cv2.resize((rng.rand(3, 4, 3) * 255).astype(np.uint8), (36, 24)))
            writer.release()
            w.writerow({"file_name": f"clip{i}.mp4", "caption": f"DISSOLVE object {i} dissolves into particles"})
    training = json.loads((EXAMPLE / "training.json").read_text())
    training["datasets"][0].update(data_root=str(root), video_resolution_buckets=[list(BUCKET)])
    validation = json.loads((EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2, num_frames=BUCKET[0], height=BUCKET[1],
                               width=BUCKET[2])]
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    out = root / "out"
    argv = _set(_train_sh_argv(root), dataset_config=root / "training.json",
                validation_dataset_file=root / "validation.json", output_dir=out, report_to="jsonl",
                train_steps=STEPS, checkpointing_steps=2, validation_steps=STEPS, precomputation_items=4,
                transformer_dtype="fp32", vae_dtype="fp32") + ["--device", "cpu"]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("finetrainers_tpu_torch.trainer.sft_trainer.trainer")
    logger.addHandler(handler)
    try:
        trainer = train_cli.main(argv, transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
    finally:
        logger.removeHandler(handler)
    return argv, out, trainer, [r.getMessage() for r in records]


def test_example_flags_train_from_videos(run):
    argv, out, trainer, messages = run
    args = trainer.args
    assert (args.model_name, args.rank, args.lora_alpha, args.gradient_checkpointing_type) == \
        ("hunyuan_video", 32, 32, "ops")
    assert args.flow_weighting_scheme == "logit_normal" and args.precomputation_once and args.enable_tiling
    assert trainer.attn_provider_training == {"transformer": "ring"}
    assert trainer.transformer.module.gradient_checkpointing == "ops"
    assert trainer.scheduler.shift == 7.0
    log = [json.loads(line) for line in (out / "logs" / "finetrainers-tpu-hunyuan_video.jsonl").read_text()
           .splitlines()]
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    latent = np.load(out / "precomputed" / PRECOMPUTED_DIR_NAME / "latent-0.npz")
    assert latent["latents"].shape == (1, 8, 3, BUCKET[1] // 2, BUCKET[2] // 2)
    condition = np.load(out / "precomputed" / PRECOMPUTED_DIR_NAME / "condition-0.npz")
    assert condition["encoder_hidden_states"].shape == (1, 256, 32)
    assert condition["pooled_projections"].shape == (1, 24)
    assert 60 <= condition["encoder_attention_mask"].sum() <= 80  # the template's 58 words and the caption's
    # Every LoRA layer trains, the refiner's too; the example's regex selects only the 60 blocks' attention.
    assert sum("--target_modules" in m and "every LoRA layer trains" in m for m in messages) == 1
    assert any("token_refiner.refiner_blocks_0.ff.net.0.proj.lora_A" in n for n in trainer._trainable)


def test_run_writes_checkpoints_adapters_videos_and_card(run):
    _, out, trainer, _ = run
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["finetrainers_step_2", "finetrainers_step_4"]
    assert sorted(p.name for p in (out / "lora_weights").iterdir()) == ["000002", f"{STEPS:06d}"]
    state, config = load_lora_weights(str(out / "lora_weights" / f"{STEPS:06d}"))
    assert config["r"] == 32 and sorted(k[len("transformer."):] for k in state) == sorted(trainer._trainable)
    assert (out / "lora_weights" / f"{STEPS:06d}" / LORA_WEIGHTS_NAME).stat().st_size > 0
    # The validation at the last step (live weights) and the final one (the exported adapter in a fresh
    # model), each one .mp4 at the request's size.
    log = [json.loads(line) for line in (out / "logs" / "finetrainers-tpu-hunyuan_video.jsonl").read_text()
           .splitlines()]
    written = [e["validation/artifact_0"] for e in log if "validation/artifact_0" in e]
    path = str(out / "validation" / f"{STEPS:06d}" / "artifact-0-0.mp4")
    assert written == [path, path]
    assert load_video(path, to_float=False).shape == (BUCKET[0], BUCKET[1], BUCKET[2], 3)
    card = (out / "README.md").read_text()
    assert "text-to-video" in card and "hunyuanvideo-community/HunyuanVideo" in card
