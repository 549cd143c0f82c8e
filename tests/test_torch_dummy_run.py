"""The dummy family through the port's command lines on the CPU, at its own
width (dim 64 in 2 heads of 32, 2 blocks): a LoRA run and a full-finetune run
under `adamw-bnb-8bit` through `finetrainers_tpu_torch.train.main`, from
videos the test writes with cv2 (3 clips of 9 frames bucketed to 9x32x48: 9 x
2 x 3 = 54 tokens after the 8x VAE and the (1, 2, 2) patches), and a request
through `finetrainers_tpu_torch.inference.main` with the run's adapter, with
and without `--quantize_int8`. Port only: the step itself is held against
JAX's in test_torch_dummy.py.

The full-finetune run keeps int8 moments for each parameter of at least 4096
elements (the feed-forward kernels, 64 x 256, the adaLN projections, 64 x
384, the attentions' and the time embedding's 64 x 64 and 256 x 64) and fp32
moments for the rest. The int8-stored request's video
differs from the full-precision one by the quantization of the base
weights: mean absolute difference under 8 levels of 255.
"""

import csv
import json

import cv2
import numpy as np
import pytest
import torch

from finetrainers_tpu_torch import inference
from finetrainers_tpu_torch import train as train_cli
from finetrainers_tpu_torch.data.utils import load_video
from finetrainers_tpu_torch.lora import load_lora_weights
from finetrainers_tpu_torch.optim8bit import Adam8bit

torch.set_num_threads(1)

BUCKET = (9, 32, 48)
STEPS = 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dummy_run")
    rng = np.random.RandomState(0)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(3):
            writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (48, 32))
            for _ in range(9):
                writer.write(cv2.resize((rng.rand(4, 6, 3) * 255).astype(np.uint8), (48, 32)))
            writer.release()
            w.writerow({"file_name": f"clip{i}.mp4", "caption": f"a ball rolls past box {i}"})
    (root / "training.json").write_text(json.dumps({"datasets": [dict(
        data_root=str(root), dataset_type="video", video_resolution_buckets=[list(BUCKET)])]}))
    (root / "validation.json").write_text(json.dumps({"data": [dict(
        caption="a ball rolls", num_inference_steps=2, num_frames=BUCKET[0], height=BUCKET[1], width=BUCKET[2])]}))
    return root


def _argv(root, out, training_type, *extra):
    return ["--model_name", "dummy", "--pretrained_model_name_or_path", "dummy", "--training_type", training_type,
            "--dataset_config", str(root / "training.json"), "--validation_dataset_file", str(root / "validation.json"),
            "--validation_steps", str(STEPS), "--output_dir", str(out), "--train_steps", str(STEPS),
            "--checkpointing_steps", str(STEPS), "--precomputation_items", "3", "--enable_precomputation",
            "--report_to", "jsonl", "--tracker_name", "dummy", "--lr", "1e-3", "--seed", "0", "--device", "cpu",
            *extra]


@pytest.fixture(scope="module")
def lora_run(data):
    out = data / "lora"
    trainer = train_cli.main(_argv(data, out, "lora", "--rank", "4", "--lora_alpha", "4"))
    return out, trainer


def test_lora_run_trains_exports_and_validates(lora_run):
    out, trainer = lora_run
    module = trainer.transformer.module
    assert module.blocks[0].attn1.head_dim == 32 and len(module.blocks) == 2
    losses = trainer.state.train_state.global_avg_losses
    assert len(losses) == STEPS and all(np.isfinite(losses))
    state, config = load_lora_weights(str(out / "lora_weights" / f"{STEPS:06d}"))
    assert config["r"] == 4 and sorted(k[len("transformer."):] for k in state) == sorted(trainer._trainable)
    assert len(state) == 2 * 2 * 10  # q, k, v, out of both attentions and the MLP's 2, A and B, in 2 blocks
    video = load_video(str(out / "validation" / f"{STEPS:06d}" / "artifact-0-0.mp4"), to_float=False)
    assert video.shape == (BUCKET[0], BUCKET[1], BUCKET[2], 3)
    assert (out / "README.md").exists()


def test_full_finetune_under_adamw_8bit(data):
    out = data / "full"
    trainer = train_cli.main(_argv(data, out, "full-finetune", "--optimizer", "adamw-bnb-8bit"))
    inner = trainer.optimizer.inner
    assert isinstance(inner, Adam8bit) and inner.min_8bit_size == 4096
    params = dict(trainer.transformer.module.named_parameters())
    eight_bit = sorted(name for name, p in params.items() if "mu_codes" in inner.state[p])
    layers = ("adaln_proj", "ff.proj_in", "ff.proj_out", *(f"attn{a}.to_{p}" for a in (1, 2)
                                                          for p in ("q", "k", "v", "out")))
    assert eight_bit == sorted([f"blocks.{i}.{layer}.weight" for i in range(2) for layer in layers]
                               + ["time_embed.linear_1.weight", "time_embed.linear_2.weight"])
    for name in eight_bit:
        st = inner.state[params[name]]
        assert st["mu_codes"].dtype == st["nu_codes"].dtype == torch.int8 and bool(st["mu_codes"].any()), name
    losses = trainer.state.train_state.global_avg_losses
    assert len(losses) == STEPS and all(np.isfinite(losses))
    assert (out / "validation" / f"{STEPS:06d}" / "artifact-0-0.mp4").exists()


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_dummy_serves_through_the_runner(lora_run, tmp_path, quantize):
    out, _ = lora_run
    argv = ["--model_name", "dummy", "--pretrained_model_name_or_path", "dummy", "--inference_type", "text_to_video",
            "--prompt", "a ball rolls", "--num_frames", "9", "--height", "32", "--width", "48",
            "--num_inference_steps", "3", "--lora_weights", str(out / "lora_weights" / f"{STEPS:06d}"),
            "--device", "cpu"]
    paths = {q: inference.main(argv + ["--output_dir", str(tmp_path / str(q))] + (["--quantize_int8"] if q else []))
             for q in sorted({False, quantize})}
    videos = {q: load_video(p[0], to_float=False).astype(np.float32) for q, p in paths.items()}
    assert all(v.shape == (9, 32, 48, 3) for v in videos.values())
    if quantize:
        assert np.abs(videos[True] - videos[False]).mean() < 8.0
