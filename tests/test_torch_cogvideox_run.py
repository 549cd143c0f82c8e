"""The crush_smol_lora CogVideoX example through the port's command line
(`finetrainers_tpu_torch.train.main`) on a tiny CogVideoX model, from videos
the test writes with cv2, against JAX's train step on the same batches.

The run takes `examples/training/sft/cogvideox/crush_smol_lora/train.sh`'s
flags as bash expands them (precompute once, a shuffle buffer of 10,
`transformer:auto`, "ops" remat, slicing and tiling, rank 32, the example's
AdamW, logit-normal weighting, which DDIM ignores, the example's
`--target_modules`), with one card's layout and these cuts for the CPU: 4
videos of 7 frames written at 24x36 and bucketed to 5x16x24 (the example
buckets to 81x480x768), 3 steps with a checkpoint every 2, the warmup cut from
300 steps to 1 (else the first update has a rate of 0), one validation
request with 2 steps at the end, the tiny spec (2 blocks, 2 heads of 64, a VAE
of 8-16 channels with 2x spatial and 2x temporal compression) with JAX's
transformer weights through the bridge, fp32, a JSONL tracker. Each step gets
JAX's draws (`fold_in(PRNGKey(42), step)` split as the JAX trainer and spec
split it: the uniform sigma draw, the posterior sample, the noise); JAX's
`value_and_grad` + optax on the batches the port trained on gives each
step's loss and the LoRA factors after the last step, held at atol 1e-4
(relative for the loss, whose DDIM weights reach 393). The run writes frames-
first moments (1, 3, 8, 8, 12), 226-slot text states, its checkpoints,
adapters, validation videos and model card.
"""

import csv
import json
import os
import pathlib
import subprocess

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models.cogvideox import CogVideoXModelSpecification as JaxSpec
from finetrainers_tpu.models.cogvideox.transformer import CogVideoXTransformer3DModel as JaxCogVideoX
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu_torch import train as train_cli
from finetrainers_tpu_torch.constants import PRECOMPUTED_DIR_NAME
from finetrainers_tpu_torch.data.utils import load_video
from finetrainers_tpu_torch.lora import load_lora_weights
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.cogvideox import CogVideoXModelSpecification, cogvideox_key_map, load_flax_params
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_cogvideox_pipeline import VAE_KW
from test_torch_cogvideox_transformer import TINY, jax_params, unflatten

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "training" / "sft" / "cogvideox" / "crush_smol_lora"
BUCKET = (5, 16, 24)
STEPS, SEED, RANK, LR = 3, 42, 32, 5e-5
ATOL = 1e-4


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
        argv[argv.index(f"--{flag}") + 1] = str(value)
    return argv


def _jax_model():
    module = JaxCogVideoX(**TINY, lora_rank=RANK, lora_alpha=RANK, dtype=jnp.float32, use_scan=False)
    return module, jax_params(module, "rope_5b")


def _jax_draws(step, shape):
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    return rng, {"sigmas": np.array(jax.random.uniform(rng_sigmas, (1,), dtype=jnp.float32)),
                 "posterior": np.array(jax.random.normal(rng_post, shape)),
                 "noise": np.array(jax.random.normal(rng_noise, shape, jnp.float32))}


def _jax_steps(batches, flat, module):
    """JAX's train step (trainer.py:239-292) on the port's batches from the same
    weights and keys: each step's loss and the LoRA factors after the last."""
    params = unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=RANK)
    spec.transformer_dtype = jnp.float32
    scheduler = spec._scheduler
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant_with_warmup", LR, warmup_steps=1,
                                                        train_steps=STEPS),
                              beta1=0.9, beta2=0.99, epsilon=1e-8, weight_decay=1e-4, max_grad_norm=1.0)

    @jax.jit
    def step(trainable, opt_state, conds, lats, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = scheduler.training_sigmas(rng_sigmas, 1, flow_weighting_scheme="logit_normal")

        def loss_fn(trainable):
            handle = JaxHandle(module, merge_params(trainable, frozen), dict(spec.transformer_config))
            pred, target, sigmas_out = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            t = jnp.clip((sigmas_out * 1000).astype(jnp.int32), 0, 999)
            w = jax_loss_weighting("logit_normal", alphas=scheduler.alphas[t]).reshape(-1, 1, 1, 1, 1)
            return jnp.mean(w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(trainable)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        return loss, optax.apply_updates(trainable, updates), opt_state

    opt_state = optimizer.init(trainable)
    losses = []
    for i, (conds, lats) in enumerate(batches):
        rng, _ = _jax_draws(i, (1, *lats["latents"].shape[1:2], lats["latents"].shape[2] // 2,
                                *lats["latents"].shape[3:]))
        loss, trainable, opt_state = step(trainable, opt_state, {k: jnp.asarray(v) for k, v in conds.items()},
                                          {k: jnp.asarray(v) for k, v in lats.items()}, rng)
        losses.append(float(loss))
    lora = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(trainable)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return losses, flax_to_torch_state_dict(lora, cogvideox_key_map)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cogvideox_run")
    rng = np.random.RandomState(0)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(4):
            writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (36, 24))
            for _ in range(7):
                writer.write(cv2.resize((rng.rand(3, 4, 3) * 255).astype(np.uint8), (36, 24)))
            writer.release()
            w.writerow({"file_name": f"clip{i}.mp4", "caption": f"A hydraulic press crushes object {i}"})
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
                lr_warmup_steps=1, transformer_dtype="fp32", vae_dtype="fp32") + ["--device", "cpu"]
    module, flat = _jax_model()
    seen = []
    train_step, load_diffusion = SFTTrainer.train_step, CogVideoXModelSpecification.load_diffusion_models

    def with_jax_draws(self, conditions, latents, generator=None, draws=None):
        seen.append(({k: v.numpy().copy() for k, v in conditions.items()},
                     {k: v.numpy().copy() for k, v in latents.items()}))
        moments = latents["latents"].shape
        _, jax_draws = _jax_draws(len(seen) - 1, (moments[0], moments[1], moments[2] // 2, *moments[3:]))
        return train_step(self, conditions, latents, draws=jax_draws)

    def bridged(self):
        out = load_diffusion(self)
        load_flax_params(out["transformer"].module, flat)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(SFTTrainer, "train_step", with_jax_draws)
    mp.setattr(CogVideoXModelSpecification, "load_diffusion_models", bridged)
    try:
        trainer = train_cli.main(argv, transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
    finally:
        mp.undo()
    return argv, out, trainer, seen, _jax_steps(seen, flat, module)


def test_example_flags_train_like_jax(run):
    _, out, trainer, seen, (losses, lora) = run
    args = trainer.args
    assert (args.model_name, args.rank, args.lora_alpha, args.gradient_checkpointing_type) == \
        ("cogvideox", 32, 32, "ops")
    assert args.flow_weighting_scheme == "logit_normal" and args.precomputation_once and args.enable_tiling
    assert trainer.attn_provider_training == {"transformer": "auto"}
    assert trainer.transformer.module.gradient_checkpointing == "ops"
    assert type(trainer.scheduler).__name__ == "CogVideoXDDIMScheduler"
    assert len(seen) == STEPS and seen[0][1]["latents"].shape == (1, 3, 8, 8, 12)
    assert seen[0][0]["encoder_hidden_states"].shape == (1, 226, 32)
    got = trainer.state.train_state.global_avg_losses
    assert len(got) == STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got, losses, atol=ATOL * max(1.0, max(losses)), rtol=0)
    assert sorted(lora) == sorted(trainer._trainable) and any(".ff.net.2." in n for n in lora)
    for name, param in trainer._trainable.items():
        np.testing.assert_allclose(param.detach().numpy(), lora[name], atol=ATOL, rtol=0, err_msg=name)


def test_run_writes_moments_checkpoints_adapters_videos_and_card(run):
    _, out, trainer, _, _ = run
    latent = np.load(out / "precomputed" / PRECOMPUTED_DIR_NAME / "latent-0.npz")
    assert latent["latents"].shape == (1, 3, 8, BUCKET[1] // 2, BUCKET[2] // 2)  # frames first
    condition = np.load(out / "precomputed" / PRECOMPUTED_DIR_NAME / "condition-0.npz")
    assert condition["encoder_hidden_states"].shape == (1, 226, 32)
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["finetrainers_step_2", "finetrainers_step_3"]
    state, config = load_lora_weights(str(out / "lora_weights" / f"{STEPS:06d}"))
    assert config["r"] == 32 and sorted(k[len("transformer."):] for k in state) == sorted(trainer._trainable)
    log = [json.loads(line) for line in (out / "logs" / "finetrainers-tpu-cogvideox.jsonl").read_text()
           .splitlines()]
    written = [e["validation/artifact_0"] for e in log if "validation/artifact_0" in e]
    path = str(out / "validation" / f"{STEPS:06d}" / "artifact-0-0.mp4")
    assert written == [path, path]  # the live weights' validation, then the final one from the export
    assert load_video(path, to_float=False).shape == (BUCKET[0], BUCKET[1], BUCKET[2], 3)
    card = (out / "README.md").read_text()
    assert "text-to-video" in card and "THUDM/CogVideoX1.5-5B" in card
