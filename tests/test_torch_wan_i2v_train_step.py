"""One Wan 2.1 image-to-video LoRA `train_step` of the port against JAX's
`value_and_grad` of the same loss and optax's adamw.

The tiny I2V model and helpers of `test_torch_wan_i2v.py` (fp32, JAX's weights
carried across with nonzero `lora_b`); the batch holds seeded VAE moments,
condition moments and the first-frame mask (in_channels 10 = 4 + 2 + 4), and
16 caption tokens with a padded mask; JAX's three draws (sigma density,
posterior sample, noise) are handed over. Loss, max_loss, grad norm, every
LoRA gradient (the port clips in place, so against JAX's times the clip
factor) and every LoRA factor after the update within atol 1e-4 (fp32 sums
in another order through two blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models.wan import WanModelSpecification, load_flax_params, wan_key_map
from finetrainers_tpu_torch.ops.flash_attention import dkdv_splits
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_wan_i2v import ATOL, TINY, _jax_transformer, _specs, _unflatten

torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 2, 8, 8)


def _train_batch():
    rng = np.random.RandomState(13)
    b, c2 = MOMENTS[:2]
    moments, cond = (rng.randn(*MOMENTS).astype(np.float32) for _ in range(2))
    for m in (moments, cond):
        m[:, c2 // 2:] = -1.0 + 0.5 * m[:, c2 // 2:]
    mask = np.zeros((b, 2, *MOMENTS[2:]), np.float32)
    mask[:, :, 0] = 1.0
    text_mask = np.zeros((b, 16), np.int32)
    text_mask[0] = 1
    text_mask[1, :5] = 1
    conditions = {"encoder_hidden_states": rng.randn(b, 16, 32).astype(np.float32), "encoder_attention_mask": text_mask}
    latents = {"latents": moments, "latent_condition": cond, "latent_condition_mask": mask,
               "latents_mean": (0.1 * rng.randn(c2 // 2)).astype(np.float32),
               "latents_std": (1.0 + 0.2 * rng.rand(c2 // 2)).astype(np.float32)}
    return conditions, latents


def test_i2v_train_step_matches_jax():
    """One I2V train step (no image embeds in the conditions, as the trainer
    gives them) against JAX's `value_and_grad` of the same loss and optax's
    adamw; JAX's draws handed over. The image branch's LoRA factors get no
    gradient in JAX's loss: optax still updates them (weight decay on zeros of
    lora_b, a decayed lora_a), and so must the port."""
    jax_spec, _ = _specs(lora_rank=RANK, lora_alpha=ALPHA)
    module, flat = _jax_transformer(RANK)
    params = _unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    conditions, latents = _train_batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = JaxScheduler(shift=3.0)
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant", 1e-4), beta1=0.9, beta2=0.95, epsilon=1e-8,
                              weight_decay=1e-4, max_grad_norm=1.0)

    @jax.jit
    def step(trainable, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = scheduler.training_sigmas(rng_sigmas, MOMENTS[0])

        def loss_fn(trainable):
            handle = JaxHandle(module, merge_params(trainable, frozen), dict(jax_spec.transformer_config))
            pred, target, sigmas_out = jax_spec.forward(handle, conds, lats, sigmas, rng_fwd)
            w = jax_loss_weighting("none", sigmas=sigmas_out).reshape(-1, 1, 1, 1, 1)
            per_sample = w * (pred - target) ** 2
            return jnp.mean(per_sample), jnp.max(jnp.mean(per_sample, axis=(1, 2, 3, 4)))

        (loss, max_loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, max_loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(2)
    loss, max_loss, grad_norm, grads, updated = step(trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    shape = (MOMENTS[0], MOMENTS[1] // 2, *MOMENTS[2:])
    draws = {"sigmas": np.array(jax.random.uniform(rng_sigmas, (MOMENTS[0],), jnp.float32)),
             "posterior": np.array(jax.random.normal(rng_post, shape, jnp.float32)),
             "noise": np.array(jax.random.normal(rng_noise, shape, jnp.float32))}

    def lora_state(tree):
        return flax_to_torch_state_dict({k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
                                         if k.endswith(("lora_a", "lora_b"))}, wan_key_map)

    grads, updated = lora_state(grads), lora_state(updated)
    spec = WanModelSpecification(transformer_config=TINY, device="cpu", transformer_dtype=torch.float32)
    trainer = SFTTrainer(BaseArgs(training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0), spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, flat)
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    np.testing.assert_allclose(float(out["loss"]), float(loss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), float(max_loss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), float(grad_norm), atol=ATOL, rtol=0)
    clip = min(1.0, 1.0 / float(grad_norm))
    params = dict(trainer.transformer.module.named_parameters())
    assert sorted(grads) == sorted(trainer._trainable) and len(grads) == 2 * 12 * 2
    for name in grads:
        np.testing.assert_allclose(params[name].grad.numpy(), clip * grads[name], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(params[name].detach().numpy(), updated[name], atol=ATOL, rtol=0, err_msg=name)
        if ".add_k_proj." in name or ".add_v_proj." in name:
            assert not params[name].grad.any(), name  # the branch did not run


@pytest.mark.parametrize("heads,splits", [(40, 1), (12, 8)])
def test_dkdv_splits_at_the_example_bucket(heads, splits):
    """K2's q-loop split for the text cross-attention at 49x480x832 (20280
    tokens, 512 keys) on an H100's 132 SMs: I2V-14B's 40 heads give 160 kv-tile
    CTAs, so no split and no reduce pass; T2V-1.3B's 12 heads give 48, cut 8
    ways."""
    assert dkdv_splits(1, heads, 20280, 512, 132)[0] == splits
