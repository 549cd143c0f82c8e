"""The control examples through the port's command line
(`finetrainers_tpu_torch.train.main`) on tiny models, from media the test
writes with cv2 (port only; the step itself is held against JAX in
test_torch_cogview4_control_step.py and test_torch_control_wan.py).

- `examples/training/control/cogview4/canny/train.sh`'s flags as bash
  expands them (control-lora rank 128, `--control_type canny`, precompute
  once, `transformer:auto`, "ops" remat, slicing and tiling, AdamW with
  `constant_with_warmup`), on one card, with these cuts: 4 images written at
  40x60 and bucketed to 32x48 (the example's bucket is 1024x1024), 4 steps
  with a save every 2, one validation request of 2 steps with a control image
  (the Canny map of one training image, made by the ported processor), the
  tiny CogView4 (2 blocks, 2 heads of 64) and a VAE with one 2x stage, fp32.
- `examples/training/control/wan/image_condition/train.sh`'s flags
  (`--control_type none`, `index` 0, `transformer:ring`), on one card: 4
  videos of 5x16x24, each with its paired `control_video` column in
  `metadata.csv`, 4 steps, a validation request with a control video, so the
  final validation runs the pipeline's control branch; the tiny Wan.

Each run: finite losses, the widened model (2x the latent channels), LoRA
and the injection layer trained, control moments precomputed beside the
latents, an adapter plus `control_aux_weights.safetensors` per save, and the
final validation from the exports in a fresh widened model.
"""

import csv
import json
import os
import pathlib
import subprocess

import cv2
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file

from finetrainers_tpu_torch import train as train_cli
from finetrainers_tpu_torch.constants import PRECOMPUTED_DIR_NAME
from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, load_lora_weights
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.processors import CannyProcessor
from finetrainers_tpu_torch.trainer.control_trainer import AUX_WEIGHTS_NAME, ControlTrainer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONTROL = REPO / "examples" / "training" / "control"
STEPS = 4
COGVIEW4 = dict(in_channels=4, out_channels=4, patch_size=2, num_attention_heads=2, attention_head_dim=64,
                num_layers=2, text_embed_dim=32, time_embed_dim=32, condition_dim=16)
WAN = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
           num_layers=2, ffn_dim=64, text_dim=32, freq_dim=16)


def _train_sh_argv(example, home):
    script = 'python() { shift; printf "%s\\0" "$@"; }; source "$0"'
    res = subprocess.run(["bash", "-c", script, str(example / "train.sh")], capture_output=True, text=True,
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


def _run(example, root, training, validation, **spec_kwargs):
    (root / "training.json").write_text(json.dumps(training))
    (root / "validation.json").write_text(json.dumps(validation))
    out = root / "out"
    argv = _set(_train_sh_argv(example, root), dataset_config=root / "training.json",
                validation_dataset_file=root / "validation.json", output_dir=out, report_to="jsonl",
                train_steps=STEPS, checkpointing_steps=2, validation_steps=1000, precomputation_items=4,
                transformer_dtype="fp32", vae_dtype="fp32") + ["--device", "cpu"]
    validated = []
    orig = ControlTrainer._validate

    def record(self, step, final=False):
        validated.append((step, final, self._init_validation_pipeline(final=final).transformer.module))
        return orig(self, step, final)

    ControlTrainer._validate = record
    try:
        trainer = train_cli.main(argv, **spec_kwargs)
    finally:
        ControlTrainer._validate = orig
    log = [json.loads(line) for line in (out / "logs" / f"{trainer.args.tracker_name}.jsonl").read_text().splitlines()]
    return trainer, out, log, validated


@pytest.fixture(scope="module")
def canny(tmp_path_factory):
    root = tmp_path_factory.mktemp("canny")
    rng = np.random.RandomState(0)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(4):
            image = cv2.resize((rng.rand(5, 6, 3) * 255).astype(np.uint8), (60, 40), interpolation=cv2.INTER_NEAREST)
            cv2.imwrite(str(root / f"photo{i}.png"), image)
            w.writerow({"file_name": f"photo{i}.png", "caption": f"a photo of a mountain lake number {i}"})
    first = cv2.cvtColor(cv2.imread(str(root / "photo0.png")), cv2.COLOR_BGR2RGB)
    edges = CannyProcessor(["control"])(input=np.moveaxis(first.astype(np.float32) / 127.5 - 1.0, -1, 0))["control"]
    cv2.imwrite(str(root / "edge_map.png"), ((np.moveaxis(edges, 0, -1) + 1.0) * 127.5).astype(np.uint8))
    training = json.loads((CONTROL / "cogview4" / "canny" / "training.json").read_text())
    training["datasets"][0].update(data_root=str(root), image_resolution_buckets=[[32, 48]])
    validation = json.loads((CONTROL / "cogview4" / "canny" / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2, height=32, width=48,
                               control_image_path=str(root / "edge_map.png"))]
    return _run(CONTROL / "cogview4" / "canny", root, training, validation, transformer_config=COGVIEW4,
                vae_config=autoencoders.AutoencoderConfig(latent_channels=4, block_out_channels=(8, 16),
                                                          layers_per_block=1, spatial_downsample=(True,),
                                                          temporal_downsample=(False,)))


def _write_video(path, rng, frames=5, size=(16, 24)):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (size[1], size[0]))
    coarse = (rng.rand(frames, size[0] // 8, size[1] // 8, 3) * 255).astype(np.uint8)
    for frame in coarse:
        writer.write(cv2.resize(frame, (size[1], size[0]), interpolation=cv2.INTER_LINEAR))
    writer.release()


@pytest.fixture(scope="module")
def image_condition(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_condition")
    rng = np.random.RandomState(1)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption", "control_video"])
        w.writeheader()
        for i in range(4):
            _write_video(root / f"clip{i}.mp4", rng)
            _write_video(root / f"control{i}.mp4", rng)
            w.writerow({"file_name": f"clip{i}.mp4", "caption": f"a sailboat number {i} on a calm bay",
                        "control_video": f"control{i}.mp4"})
    training = json.loads((CONTROL / "wan" / "image_condition" / "training.json").read_text())
    training["datasets"][0].update(data_root=str(root), video_resolution_buckets=[[5, 16, 24]])
    validation = json.loads((CONTROL / "wan" / "image_condition" / "validation.json").read_text())
    validation["data"] = [dict(validation["data"][0], num_inference_steps=2, height=16, width=24, num_frames=5,
                               control_video_path=str(root / "control0.mp4"))]
    return _run(CONTROL / "wan" / "image_condition", root, training, validation, transformer_config=WAN,
                vae_config=autoencoders.AutoencoderConfig(latent_channels=4, block_out_channels=(8, 16),
                                                          layers_per_block=1, spatial_downsample=(True,),
                                                          temporal_downsample=(True,)))


@pytest.mark.parametrize("example", ["canny", "image_condition"])
def test_control_example_trains_through_its_command_line(example, request):
    trainer, out, log, validated = request.getfixturevalue(example)
    args = trainer.args
    injection = "patch_embed.proj" if example == "canny" else "patch_embedding"
    assert (args.training_type, args.rank, args.lora_alpha, args.gradient_checkpointing_type) == (
        "control-lora", 128, 128, "ops")
    assert args.control_type == ("canny" if example == "canny" else "none") and args.frame_conditioning_type == "index"
    assert trainer.transformer.config["in_channels"] == 8 and trainer.transformer.module.gradient_checkpointing == "ops"
    assert trainer.model_specification.transformer_config["in_channels"] == 4
    assert {f"{injection}.weight", f"{injection}.bias"} <= set(trainer._trainable)
    assert all(".lora_" in n or n.startswith(injection + ".") for n in trainer._trainable)
    losses = [e["train/global_avg_loss"] for e in log if "train/global_avg_loss" in e]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    latent = np.load(out / "precomputed" / PRECOMPUTED_DIR_NAME / "latent-0.npz")
    assert latent["control_latents"].shape == latent["latents"].shape
    if example == "canny":
        assert latent["latents"].shape == (1, 8, 16, 24)
        np.testing.assert_array_equal(latent["original_size"], [[32, 48]])
    else:
        assert latent["latents"].shape == (1, 8, 3, 8, 12)


@pytest.mark.parametrize("example", ["canny", "image_condition"])
def test_control_example_exports_and_validates_from_them(example, request):
    trainer, out, log, validated = request.getfixturevalue(example)
    injection = "patch_embed_proj" if example == "canny" else "patch_embedding"
    assert sorted(p.name for p in (out / "lora_weights").iterdir()) == ["000002", f"{STEPS:06d}"]
    export = out / "lora_weights" / f"{STEPS:06d}"
    state, config = load_lora_weights(str(export / LORA_WEIGHTS_NAME))
    assert config["r"] == 128 and all(".lora_" in k for k in state)
    assert sorted(k[len("transformer."):] for k in state) == sorted(n for n in trainer._trainable if ".lora_" in n)
    aux = np_load_file(str(export / AUX_WEIGHTS_NAME))
    assert sorted(aux) == [f"{injection}.bias", f"{injection}.kernel"]
    module = trainer.transformer.module
    weight = module.get_submodule(injection.replace("_proj", ".proj")).weight.detach().numpy()
    np.testing.assert_array_equal(aux[f"{injection}.kernel"], weight.T)
    # Only the final validation runs (every 1000 steps otherwise), from a fresh widened model with both applied.
    assert [(step, final) for step, final, _ in validated] == [(STEPS, True)]
    fresh = validated[0][2]
    assert fresh is not module
    for name, param in module.named_parameters():
        assert torch.equal(dict(fresh.named_parameters())[name].detach(), param.detach()), name
    ext = "png" if example == "canny" else "mp4"
    written = [e["validation/artifact_0"] for e in log if "validation/artifact_0" in e]
    assert written == [str(out / "validation" / f"{STEPS:06d}" / f"artifact-0-0.{ext}")]
