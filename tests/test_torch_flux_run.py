"""The flux_dev LoRA example through the port's command line
(`finetrainers_tpu_torch.train.main`) on a tiny Flux model, from images the
test writes with cv2.

The run takes `examples/training/sft/flux_dev/raider_white_tarot/train.sh`'s
flags as bash expands them (precompute once, a shuffle buffer of 10,
`transformer:auto`, "ops" remat, slicing and tiling, rank 32, the example's
AdamW, logit-normal weighting, the example's `--target_modules`), with one
card's layout and these cuts for the CPU: 4 images written at 40x60 and
bucketed to 32x48 (the example buckets to 1280x720), 4 steps with a
checkpoint every 2, one validation request with 2 steps at the end, the
tiny spec (2 dual and 2 single blocks, 2 heads of 64, a VAE of 8-16
channels with 2x spatial compression), fp32, a JSONL tracker. The run
precomputes image moments (1, 8, 16, 24), trains every LoRA layer (the
example's regex selects fewer, so the trainer warns once), and writes its
checkpoints, adapters (whose keys are the model's LoRA factors), the
validation images as .png (from the live weights, then from the exported
adapter in a fresh model) and the model card tagged text-to-image.
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
from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, load_lora_weights
from finetrainers_tpu_torch.models import autoencoders
from test_torch_flux_pipeline import TINY, VAE_KW

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "training" / "sft" / "flux_dev" / "raider_white_tarot"
BUCKET = (32, 48)
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
    root = tmp_path_factory.mktemp("flux_run")
    rng = np.random.RandomState(0)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(4):
            image = cv2.resize((rng.rand(5, 6, 3) * 255).astype(np.uint8), (60, 40), interpolation=cv2.INTER_LINEAR)
            cv2.imwrite(str(root / f"card{i}.png"), image)
            w.writerow({"file_name": f"card{i}.png", "caption": f"a trtcrd of card {i}, tarot style"})
    training = json.loads((EXAMPLE / "training.json").read_text())
    training["datasets"][0].update(data_root=str(root), image_resolution_buckets=[list(BUCKET)])
    validation = json.loads((EXAMPLE / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2, height=BUCKET[0], width=BUCKET[1])]
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


def test_example_flags_train_from_images(run):
    argv, out, trainer, messages = run
    args = trainer.args
    assert (args.model_name, args.rank, args.lora_alpha, args.gradient_checkpointing_type) == ("flux", 32, 32, "ops")
    assert args.flow_weighting_scheme == "logit_normal" and args.precomputation_once and args.enable_tiling
    assert trainer.attn_provider_training == {"transformer": "auto"}
    assert trainer.transformer.module.gradient_checkpointing == "ops"
    log = [json.loads(line) for line in (out / "logs" / "finetrainers-tpu-flux.jsonl").read_text().splitlines()]
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    latent = np.load(out / "precomputed" / PRECOMPUTED_DIR_NAME / "latent-0.npz")
    assert latent["latents"].shape == (1, 8, BUCKET[0] // 2, BUCKET[1] // 2)
    condition = np.load(out / "precomputed" / PRECOMPUTED_DIR_NAME / "condition-0.npz")
    assert condition["encoder_hidden_states"].shape == (1, 512, 32)
    assert condition["pooled_projections"].shape == (1, 24)
    # Every LoRA layer trains; the example's regex selects only the dual blocks' attention.
    assert sum("--target_modules" in m and "every LoRA layer trains" in m for m in messages) == 1
    assert any(".single_transformer_blocks.0.proj_mlp.lora_A" in f".{n}" for n in trainer._trainable)


def test_run_writes_checkpoints_adapters_images_and_card(run):
    _, out, trainer, _ = run
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["finetrainers_step_2", "finetrainers_step_4"]
    assert sorted(p.name for p in (out / "lora_weights").iterdir()) == ["000002", f"{STEPS:06d}"]
    state, config = load_lora_weights(str(out / "lora_weights" / f"{STEPS:06d}"))
    assert config["r"] == 32 and sorted(k[len("transformer."):] for k in state) == sorted(trainer._trainable)
    assert (out / "lora_weights" / f"{STEPS:06d}" / LORA_WEIGHTS_NAME).stat().st_size > 0
    # The validation at the last step (live weights) and the final one (the exported adapter in a fresh
    # model), each one .png at the request's size.
    log = [json.loads(line) for line in (out / "logs" / "finetrainers-tpu-flux.jsonl").read_text().splitlines()]
    written = [e["validation/artifact_0"] for e in log if "validation/artifact_0" in e]
    path = str(out / "validation" / f"{STEPS:06d}" / "artifact-0-0.png")
    assert written == [path, path]
    assert cv2.imread(path).shape == (*BUCKET, 3)
    card = (out / "README.md").read_text()
    assert "text-to-image" in card and "black-forest-labs/FLUX.1-dev" in card
