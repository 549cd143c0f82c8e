"""`SFTTrainer.run()` through the port's command line (`finetrainers_tpu_torch.train.main`)
on a tiny Wan 2.1 model, on videos the test writes with cv2, against the JAX
package's data stage and train step.

The run takes the Wan example's flags (train.sh: precompute once, a shuffle
buffer of 10, `transformer:ring`, "ops" remat, slicing and tiling, rank and
optimizer, logit-normal weighting), cut to the CPU: 4 videos of 9 frames at
32x48, a 2-block model with 2 heads of 64 (text width 32), a VAE of 4-8
channels with the Wan VAE's 8x spatial and 4x temporal compression, fp32,
validation of one 2-step request. The JAX weights (transformer and VAE) are
carried across by the weight bridge.

- The batches of each step equal the JAX data stage's on the same files
  (`initialize_dataset`, the preprocessing wrapper, the seeded shuffle buffer,
  `DPDataLoader`, the on-disk precompute of 4 items cycled, the resolution
  sampler and the spec's collation): the same text states, VAE moments within
  atol 1e-4 (the float frames of the two packages may differ by an ulp).
- With JAX's draws handed over (`fold_in(PRNGKey(seed), step)` split as the
  JAX trainer splits it), each step's loss and the LoRA factors after the
  second step equal JAX's `value_and_grad` and optax update within atol 1e-4.
- A run broken after 2 steps and resumed from "latest" ends bit-equal to the
  unbroken 4-step run (LoRA factors, AdamW moments, losses) and logs the same
  sample ids for every step; the checkpoints hold the loader's snapshot. A
  trainer that `main` returned is freed as soon as it is dropped.
- The run writes its checkpoints, adapters, validation videos, JSONL log and
  model card under `output_dir`.
"""

import csv
import functools
import json
import weakref

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu import data as jax_data
from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.wan import WanModelSpecification as JaxSpec
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import train as train_cli
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle
from finetrainers_tpu_torch.models.wan import WanModelSpecification, load_flax_params, wan_key_map
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=2, ffn_dim=64, text_dim=32, freq_dim=16)
VAE = autoencoders.AutoencoderConfig(latent_channels=4, block_out_channels=(4, 8, 8, 8), layers_per_block=1,
                                     spatial_downsample=(True, True, True), temporal_downsample=(False, True, True))
RANK, SEED, ITEMS, STEPS = 4, 42, 4, 4
ATOL = 1e-4
FLAGS = dict(lr=5e-5, warmup=1, beta1=0.9, beta2=0.99, weight_decay=1e-4, epsilon=1e-8, max_grad_norm=1.0)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_data")
    rng = np.random.RandomState(0)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption"])
        w.writeheader()
        for i in range(4):
            writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (48, 32))
            for _ in range(9):
                writer.write((rng.rand(32, 48, 3) * 255).astype(np.uint8))
            writer.release()
            w.writerow({"file_name": f"clip{i}.mp4", "caption": f"The video shows a press crushing object {i}"})
    config = {"datasets": [{"data_root": str(root), "dataset_type": "video", "id_token": "PIKA_CRUSH",
                            "video_resolution_buckets": [[9, 32, 48]], "reshape_mode": "bicubic",
                            "remove_common_llm_caption_prefixes": True}]}
    (root / "training.json").write_text(json.dumps(config))
    (root / "validation.json").write_text(json.dumps({"data": [{
        "caption": "PIKA_CRUSH a press", "image_path": None, "video_path": None, "num_inference_steps": 2,
        "height": 32, "width": 48, "num_frames": 9, "frame_rate": 25}]}))
    return root


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


@functools.lru_cache(maxsize=None)
def _weights():
    """The JAX transformer and VAE weights (nonzero lora_b, noisy biases and norms), flattened."""
    module = JaxWan(**TINY, lora_rank=RANK, lora_alpha=RANK, dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 4, 1, 4, 4)), jnp.zeros((1, 8, 32)),
                          jnp.zeros((1,)))
    rng = np.random.RandomState(7)
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    for key in flat:
        if key.endswith("lora_b"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale", "scale_shift_table")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    vae = jax_ae.AutoencoderKL3D(VAE, dtype=jnp.float32)
    vae_params = drawn_params(vae, jnp.zeros((1, 3, 1, 8, 8)), seed=1)
    vae_flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(vae_params)).items()}
    return module, flat, vae, vae_flat


VAE_CONFIG = {"latent_channels": 4, "spatial_compression_ratio": 8, "temporal_compression_ratio": 4,
              "latents_mean": np.zeros(4, np.float32), "latents_std": np.ones(4, np.float32)}


@pytest.fixture
def bridged(monkeypatch):
    """The port's Wan spec loads the JAX weights: the transformer through
    `load_flax_params`, the VAE through `load_flax_vae_params`."""
    _, flat, _, vae_flat = _weights()
    load_diffusion = WanModelSpecification.load_diffusion_models

    def load_diffusion_models(self):
        out = load_diffusion(self)
        load_flax_params(out["transformer"].module, flat)
        return out

    def load_latent_models(self):
        vae = autoencoders.load_flax_vae_params(autoencoders.AutoencoderKL3D(VAE, dtype=torch.float32), vae_flat)
        return {"vae": ModelHandle(vae.eval(), dict(VAE_CONFIG))}

    monkeypatch.setattr(WanModelSpecification, "load_diffusion_models", load_diffusion_models)
    monkeypatch.setattr(WanModelSpecification, "load_latent_models", load_latent_models)


def _argv(dataset, output_dir, steps, *extra):
    """train.sh's flags (one card), cut to the CPU run."""
    return ["--parallel_backend", "jax", "--model_name", "wan", "--pretrained_model_name_or_path",
            "Wan-AI/Wan2.1-T2V-1.3B-Diffusers", "--transformer_dtype", "fp32", "--vae_dtype", "fp32",
            "--dataset_config", str(dataset / "training.json"), "--dataset_shuffle_buffer_size", "10",
            "--enable_precomputation", "--precomputation_items", str(ITEMS), "--precomputation_once",
            "--dataloader_num_workers", "0", "--flow_weighting_scheme", "logit_normal",
            "--attn_provider_training", "transformer:ring", "--training_type", "lora", "--seed", str(SEED),
            "--batch_size", "1", "--train_steps", str(steps), "--rank", str(RANK), "--lora_alpha", str(RANK),
            "--target_modules", "blocks.*(to_q|to_k|to_v|to_out.0)", "--gradient_accumulation_steps", "1",
            "--gradient_checkpointing", "--gradient_checkpointing_type", "ops", "--checkpointing_steps", "2",
            "--checkpointing_limit", "2", "--enable_slicing", "--enable_tiling", "--optimizer", "adamw",
            "--lr", str(FLAGS["lr"]), "--lr_scheduler", "constant_with_warmup", "--lr_warmup_steps",
            str(FLAGS["warmup"]), "--beta1", "0.9", "--beta2", "0.99", "--weight_decay", "1e-4", "--epsilon", "1e-8",
            "--max_grad_norm", "1.0", "--validation_dataset_file", str(dataset / "validation.json"),
            "--validation_steps", "4", "--tracker_name", "finetrainers-tpu-wan", "--output_dir", str(output_dir),
            "--report_to", "jsonl", "--device", "cpu", *extra]


def _jax_batches(dataset, tmp_path, n):
    """JAX's data stage on the same files, as its trainer builds it (trainer.py:318-383, :657-698)."""
    _, _, vae, vae_flat = _weights()
    handle = JaxHandle(vae, _unflatten(vae_flat), dict(VAE_CONFIG))
    handle.enable_slicing()
    handle.enable_tiling()
    spec = JaxSpec(transformer_config=TINY)
    encoder = JaxHashEncoder(hidden_size=32, max_length=128)
    entry = json.loads((dataset / "training.json").read_text())["datasets"][0]
    ds = jax_data.initialize_dataset(entry["data_root"], "video", infinite=True)
    wrapped = jax_data.wrap_iterable_dataset_for_preprocessing(ds, "video", {
        "id_token": entry["id_token"], "video_resolution_buckets": [tuple(b) for b in entry["video_resolution_buckets"]],
        "reshape_mode": "bicubic", "remove_common_llm_caption_prefixes": True, "decode_workers": 0})
    loader = jax_data.DPDataLoader(0, jax_data.combine_datasets([wrapped], buffer_size=10, shuffle=True),
                                   batch_size=1, collate_fn=lambda items: items[0])
    it = iter(loader)
    pre = jax_data.initialize_preprocessor(0, ITEMS, {
        "condition": lambda **s: spec.prepare_conditions(caption=s["caption"], text_encoder=encoder),
        "latent": lambda **s: spec.prepare_latents(vae=handle, video=s["video"])},
        save_dir=str(tmp_path / "jax_precomputed"), enable_precomputation=True)
    conditions = iter(pre.consume_once("condition", it, cache_samples=True))
    latents = iter(pre.consume_once("latent", it, use_cached_samples=True, drop_samples=True))
    sampler = jax_data.ResolutionSampler(1, spec._resolution_dim_keys)
    out = []
    while len(out) < n:
        sampler.consume(next(conditions), next(latents))
        if sampler.ready:
            c, lat = sampler.get_batch()
            out.append((spec.collate_conditions(c), spec.collate_latents(lat)))
    return out


def _jax_steps(batches):
    """JAX's train step (trainer.py:229-292) on `batches` from the same weights:
    each step's loss, its draws (for the port), and the LoRA factors after."""
    module, flat, _, _ = _weights()
    params = _unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=RANK)
    spec.transformer_dtype = jnp.float32
    scheduler = JaxScheduler(shift=3.0)
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant_with_warmup", FLAGS["lr"], warmup_steps=1,
                                                        train_steps=STEPS),
                              beta1=0.9, beta2=0.99, epsilon=1e-8, weight_decay=1e-4, max_grad_norm=1.0)

    @jax.jit
    def step(trainable, opt_state, conds, lats, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = scheduler.training_sigmas(rng_sigmas, 1, flow_weighting_scheme="logit_normal")

        def loss_fn(trainable):
            handle = JaxHandle(module, merge_params(trainable, frozen), dict(spec.transformer_config))
            pred, target, sigmas_out = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            w = jax_loss_weighting("logit_normal", sigmas=sigmas_out).reshape(-1, 1, 1, 1, 1)
            return jnp.mean(w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(trainable)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        return loss, optax.apply_updates(trainable, updates), opt_state

    opt_state = optimizer.init(trainable)
    losses, draws = [], []
    for i, (conds, lats) in enumerate(batches):
        rng = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        rng_sigmas, rng_fwd = jax.random.split(rng)
        rng_post, rng_noise = jax.random.split(rng_fwd)
        shape = (1, lats["latents"].shape[1] // 2, *lats["latents"].shape[2:])
        draws.append({"sigmas": np.array(jax.random.normal(rng_sigmas, (1,), jnp.float32)),
                      "posterior": np.array(jax.random.normal(rng_post, shape, jnp.float32)),
                      "noise": np.array(jax.random.normal(rng_noise, shape, jnp.float32))})
        loss, trainable, opt_state = step(trainable, opt_state, {k: jnp.asarray(v) for k, v in conds.items()},
                                          {k: jnp.asarray(v) for k, v in lats.items()}, rng)
        losses.append(float(loss))
    lora = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(trainable)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return losses, draws, flax_to_torch_state_dict(lora, wan_key_map)


def test_run_batches_and_steps_match_jax(dataset, tmp_path, bridged, monkeypatch):
    jax_batches = _jax_batches(dataset, tmp_path, 2)
    losses, draws, lora = _jax_steps(jax_batches)
    seen = []
    train_step = SFTTrainer.train_step

    def with_jax_draws(self, conditions, latents, generator=None, draws_=None):
        seen.append(({k: v.clone() for k, v in conditions.items()}, {k: v.clone() for k, v in latents.items()}))
        return train_step(self, conditions, latents, draws=draws[len(seen) - 1])

    monkeypatch.setattr(SFTTrainer, "train_step", with_jax_draws)
    trainer = train_cli.main(_argv(dataset, tmp_path / "out", 2), transformer_config=TINY, vae_config=VAE)
    assert trainer.attn_provider_training == {"transformer": "ring"}
    assert len(seen) == 2
    for (conditions, latents), (jax_conds, jax_lats) in zip(seen, jax_batches):
        assert conditions.keys() == jax_conds.keys() and latents.keys() == jax_lats.keys()
        for key in conditions:
            assert np.array_equal(conditions[key].numpy(), jax_conds[key]), key
        assert tuple(latents["latents"].shape) == jax_lats["latents"].shape == (1, 8, 3, 4, 6)
        np.testing.assert_allclose(latents["latents"].numpy(), jax_lats["latents"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(trainer.state.train_state.global_avg_losses, losses, atol=ATOL, rtol=0)
    for name, param in trainer._trainable.items():
        np.testing.assert_allclose(param.detach().numpy(), lora[name], atol=ATOL, rtol=0, err_msg=name)
    out = tmp_path / "out"
    for path in ("checkpoints/finetrainers_step_2/state.pt", "lora_weights/000002/pytorch_lora_weights.safetensors",
                 "validation/000002/artifact-0-0.mp4", "logs/finetrainers-tpu-wan.jsonl", "README.md",
                 "precomputed/finetrainers-precomputed-data/latent-3.npz"):
        assert (out / path).is_file(), path
    state = torch.load(out / "checkpoints/finetrainers_step_2/state.pt", weights_only=True)
    assert state["dataloader"]["round_items"] == 2 and "dp_rank_0" in state["dataloader"]["loader"]


def _log(output_dir, key):
    lines = (output_dir / "logs" / "finetrainers-tpu-wan.jsonl").read_text().splitlines()
    return [json.loads(line)[key] for line in lines if key in line]


def _moments(trainer):
    return [t for s in trainer.optimizer.state_dict()["inner"]["state"].values() for t in (s["exp_avg"],
                                                                                          s["exp_avg_sq"])]


def test_resumed_run_is_bit_equal_with_the_same_samples(dataset, tmp_path):
    kw = dict(transformer_config=TINY, vae_config=VAE)
    unbroken = train_cli.main(_argv(dataset, tmp_path / "unbroken", STEPS), **kw)
    train_cli.main(_argv(dataset, tmp_path / "broken", 2), **kw)
    resumed = train_cli.main(_argv(dataset, tmp_path / "broken", STEPS, "--resume_from_checkpoint", "latest"), **kw)
    assert resumed.checkpointer.all_steps() == [2, 4]
    for name, param in unbroken._trainable.items():
        assert torch.equal(param, resumed._trainable[name]), name
    assert all(torch.equal(a, b) for a, b in zip(_moments(unbroken), _moments(resumed)))
    assert _log(tmp_path / "unbroken", "train/global_avg_loss") == _log(tmp_path / "broken", "train/global_avg_loss")
    ids = _log(tmp_path / "unbroken", "train/sample_ids")
    assert len(ids) == STEPS and ids == _log(tmp_path / "broken", "train/sample_ids")
    assert all(i.endswith(".mp4") for i in ids) and len(set(ids)) > 1
    dropped = weakref.ref(unbroken)
    del unbroken
    assert dropped() is None  # nothing of the run refers back to the trainer: its model is freed at once
