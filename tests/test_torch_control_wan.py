"""The Wan control slice: one `ControlTrainer.train_step` on the Wan control
spec against JAX's `value_and_grad` through `WanControlModelSpecification.forward`.

Both sides run the tiny Wan model in fp32 (2 blocks, 2 heads of 64, ffn 64,
text width 32), widened to 8 input channels (12 with the concatenated
mask), LoRA rank 4, JAX's weights through `load_flax_params` (nonzero
`lora_b`, noise on every bias and norm scale). The step's batch: seeded
moments (2, 8, 3, 4, 4) and control moments of the same shape, non-trivial
latent statistics (both halves of both normalised with them, the Wan quirk),
16 caption tokens with a padded mask. JAX's draws (sigma density, posterior,
noise, and the frame-conditioning `randint`/`uniform` of `split(rng, 4)[3]`)
are handed to the port. Trained: every LoRA factor and the injection layer
`patch_embedding` at full rank. Compared at atol 1e-4: loss, max loss, grad
norm, every trained gradient and value after the update, under the example's
`index` type and under `random` with the mask joined. The pipeline's control
branch is in test_torch_control_wan_pipeline.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.lora import trainable_mask as jax_trainable_mask
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu.models.wan.control_specification import WanControlModelSpecification as JaxControlSpec
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models.wan import WanControlModelSpecification, load_flax_params, wan_key_map
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer.control_trainer import ControlTrainer
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=2, ffn_dim=64, text_dim=32, freq_dim=16)
RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 3, 4, 4)  # (B, 2C, F, H, W)
TEXT_LEN = 16
ATOL = 1e-4
MEAN = np.asarray([0.1, -0.2, 0.05, 0.3], np.float32)
STD = np.asarray([1.2, 0.8, 1.1, 0.9], np.float32)


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


@functools.lru_cache(maxsize=None)
def jax_params(in_channels, lora_rank=RANK):
    module = JaxWan(**dict(TINY, in_channels=in_channels), lora_rank=lora_rank, lora_alpha=ALPHA, dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, in_channels, 1, 4, 4)),
                          jnp.zeros((1, 8, 32)), jnp.zeros((1,)))
    flat = _flat(params)
    rng = np.random.RandomState(7)
    for key in flat:
        if key.endswith("lora_b"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale", "scale_shift_table")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return module, flat


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _batch():
    rng = np.random.RandomState(11)
    b, c2 = MOMENTS[:2]
    latents = {}
    for name in ("latents", "control_latents"):
        moments = rng.randn(*MOMENTS).astype(np.float32)
        moments[:, c2 // 2:] = -1.0 + 0.5 * moments[:, c2 // 2:]
        latents[name] = moments
    latents.update(latents_mean=MEAN, latents_std=STD)
    mask = np.zeros((b, TEXT_LEN), np.int32)
    mask[0, :] = 1
    mask[1, :5] = 1
    conditions = {"encoder_hidden_states": rng.randn(b, TEXT_LEN, 32).astype(np.float32),
                  "encoder_attention_mask": mask}
    return conditions, latents


def _trained(tree):
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if k.endswith(("lora_a", "lora_b")) or k.startswith("patch_embedding.")}
    return flax_to_torch_state_dict(flat, wan_key_map)


@functools.lru_cache(maxsize=None)
def _jax_reference(ftype, concatenate_mask):
    spec = JaxControlSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA, frame_conditioning_type=ftype,
                          frame_conditioning_index=0, frame_conditioning_concatenate_mask=concatenate_mask)
    spec.transformer_dtype = jnp.float32
    module, flat = jax_params(12 if concatenate_mask else 8)
    params = unflatten(flat)
    is_trained = lambda path: "lora_a" in path or "lora_b" in path or "patch_embedding" in path  # noqa: E731
    trainable, frozen = split_params(params, jax_trainable_mask(params, is_trained))
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = JaxScheduler(shift=3.0)
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant", 1e-4), beta1=0.9, beta2=0.95, epsilon=1e-8,
                              weight_decay=1e-4, max_grad_norm=1.0)
    batch = MOMENTS[0]

    @jax.jit
    def step(trainable, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = scheduler.training_sigmas(rng_sigmas, batch)

        def loss_fn(trainable):
            handle = ModelHandle(module, merge_params(trainable, frozen), dict(spec.transformer_config))
            pred, target, sigmas_out = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            w = jax_loss_weighting("none", sigmas=sigmas_out).reshape(-1, 1, 1, 1, 1)
            per_sample = w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2
            return jnp.mean(per_sample), jnp.max(jnp.mean(per_sample, axis=(1, 2, 3, 4)))

        (loss, max_loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, max_loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(3)
    loss, max_loss, grad_norm, grads, updated = step(trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise, _, rng_fc = jax.random.split(rng_fwd, 4)
    b, c2, f, h, w = MOMENTS
    draws = {
        "sigmas": np.array(jax.random.uniform(rng_sigmas, (batch,), jnp.float32)),  # the "none" density
        "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, f, h, w), jnp.float32)),
        "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, f, h, w), jnp.float32)),
        "frame_keep": int(jax.random.randint(rng_fc, (), 1, f + 1)),
        "frame_scores": np.array(jax.random.uniform(jax.random.fold_in(rng_fc, 1), (f,))),
    }
    return (flat, conditions, latents, draws, float(loss), float(max_loss), float(grad_norm), _trained(grads),
            _trained(updated), _trained(params))


@pytest.mark.parametrize("ftype,concatenate_mask", [("index", False), ("random", True)],
                         ids=["index", "random_with_mask"])
def test_wan_control_train_step_matches_jax(ftype, concatenate_mask):
    flat, conditions, latents, draws, loss, max_loss, grad_norm, grads, updated, initial = _jax_reference(
        ftype, concatenate_mask)
    spec = get_model_specification_cls("wan", "control-lora")(device="cpu", transformer_config=TINY,
                                                              transformer_dtype=torch.float32)
    trainer = ControlTrainer(BaseArgs(training_type="control-lora", rank=RANK, lora_alpha=ALPHA, seed=0,
                                      control_type="none", frame_conditioning_type=ftype,
                                      frame_conditioning_concatenate_mask=concatenate_mask), spec)
    trainer.prepare()
    assert (spec.frame_conditioning_type, spec.frame_conditioning_concatenate_mask) == (ftype, concatenate_mask)
    assert trainer.transformer.config["in_channels"] == (12 if concatenate_mask else 8)
    module = trainer.transformer.module
    load_flax_params(module, flat)
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    np.testing.assert_allclose(float(out["loss"]), loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), max_loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), grad_norm, atol=ATOL, rtol=0)
    clip = min(1.0, 1.0 / grad_norm)
    params = dict(module.named_parameters())
    assert sorted(grads) == sorted(trainer._trainable) and {"patch_embedding.weight", "patch_embedding.bias"} <= set(grads)
    for name in grads:
        np.testing.assert_allclose(params[name].grad.numpy(), clip * grads[name], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(params[name].detach().numpy(), updated[name], atol=ATOL, rtol=0, err_msg=name)
        assert not np.allclose(params[name].detach().numpy(), initial[name], atol=1e-7, rtol=0), name


def test_wan_control_forward_needs_control_latents():
    spec = WanControlModelSpecification(device="cpu", transformer_config=TINY, transformer_dtype=torch.float32)
    handle = spec.load_diffusion_models(new_in_features=8)["transformer"]
    conditions, latents = _batch()
    latents.pop("control_latents")
    with pytest.raises(ValueError, match="control_video column"):
        spec.forward(handle, {k: torch.from_numpy(v) for k, v in conditions.items()},
                     {k: torch.from_numpy(v) for k, v in latents.items()}, torch.full((2,), 0.5))
