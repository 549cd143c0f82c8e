"""The Wan LoRA training slice as a whole: one `SFTTrainer.train_step` of the
port on the Wan spec against JAX's `value_and_grad` of the same LoRA
flow-matching loss.

Both sides run a tiny Wan 2.1 model in fp32 (2 blocks, 2 heads of 64, ffn 64,
text width 32), with the JAX weights through `load_flax_params` (nonzero
`lora_b`, noise on every bias, norm scale and `scale_shift_table`). The batch
is seeded VAE moments (2, 8, 2, 8, 8) -> 2 x 4 x 4 = 32 tokens per sample, with
non-trivial latent statistics, and 16 caption tokens with a padded mask. The JAX
step is `_build_train_step`'s: sigmas from Wan's `FlowMatchEulerScheduler(shift=3.0)`
(no extra flow shift), `WanModelSpecification.forward`, the unweighted
flow-matching loss, optax `get_optimizer("adamw", ...)` with the trainer's
defaults. Its random draws (sigma density, posterior sample, noise) are rebuilt
with the same keys and handed to the port. Compared at atol 1e-4 (fp32 sums in
another order through two blocks): loss, max_loss, grad norm, every LoRA
gradient (the port clips in place, so against JAX's times the clip factor) and
every LoRA factor after the update. The port's step must be the same under
each of the four kernel switches (FINETRAINERS_FLASH_SKEW, _TWOPASS, _TWOLEVEL,
_FUSED_BWD), whose plain versions it then takes on the CPU.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.models.wan import WanModelSpecification as JaxSpec
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models.wan import load_flax_params, wan_key_map
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer import SFTTrainer

torch.set_num_threads(1)
flash_ops = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

TINY = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=2, ffn_dim=64, text_dim=32, freq_dim=16)
RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 2, 8, 8)  # (B, 2C, F, H, W)
TEXT_LEN = 16
ATOL = 1e-4
# switch -> (the plain version it sends the CPU calls to, its calls in one step of the 2-block model:
# self- and cross-attention per block, or only cross-attention for skew, which RoPE gates off)
SWITCHES = {
    "FINETRAINERS_FLASH_SKEW": ("flash_forward_skew_reference", 2),
    "FINETRAINERS_FLASH_TWOPASS": ("flash_forward_twopass_reference", 4),
    "FINETRAINERS_FLASH_TWOLEVEL": ("flash_forward_two_level_reference", 4),
    "FINETRAINERS_FLASH_FUSED_BWD": ("flash_backward_fused_reference", 4),
}


def _jax_params(module):
    params = jax.jit(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 1, 4, 4)), jnp.zeros((1, 8, 32)),
                                         jnp.zeros((1,)))["params"])()
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    rng = np.random.RandomState(7)
    for key in flat:
        if key.endswith("lora_b"):  # starts at zero: make the LoRA branch and lora_a's gradient count
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale", "scale_shift_table")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return flat


def _batch():
    rng = np.random.RandomState(11)
    b, c2 = MOMENTS[:2]
    moments = rng.randn(*MOMENTS).astype(np.float32)
    moments[:, c2 // 2:] = -1.0 + 0.5 * moments[:, c2 // 2:]  # log-variance
    mask = np.zeros((b, TEXT_LEN), np.int32)
    mask[0, :] = 1
    mask[1, :5] = 1  # padded caption
    conditions = {"encoder_hidden_states": rng.randn(b, TEXT_LEN, 32).astype(np.float32),
                  "encoder_attention_mask": mask}
    latents = {"latents": moments, "latents_mean": (0.1 * rng.randn(c2 // 2)).astype(np.float32),
               "latents_std": (1.0 + 0.2 * rng.rand(c2 // 2)).astype(np.float32)}
    return conditions, latents


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
def _jax_reference():
    """JAX's train step on the tiny Wan spec: its loss, max_loss, grad norm,
    gradients and LoRA factors before and after the update (by peft name), and
    its draws."""
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    module = JaxWan(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32)
    flat = _jax_params(module)
    params = _unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = JaxScheduler(shift=3.0)  # Wan's (load_diffusion_models)
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

    rng = jax.random.PRNGKey(2)
    loss, max_loss, grad_norm, grads, updated = step(trainable, rng)
    # The same draws, rebuilt with the step's keys (training_sigmas' "none"
    # density; the two draws of spec.forward).
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    b, c2, f, h, w = MOMENTS
    draws = {
        "sigmas": np.array(jax.random.uniform(rng_sigmas, (batch,), jnp.float32)),
        "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, f, h, w), jnp.float32)),
        "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, f, h, w), jnp.float32)),
    }

    def lora_state(tree):  # peft names and layouts
        flat_tree = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
                     if k.endswith(("lora_a", "lora_b"))}
        return flax_to_torch_state_dict(flat_tree, wan_key_map)

    return (flat, conditions, latents, draws, float(loss), float(max_loss), float(grad_norm), lora_state(grads),
            lora_state(updated), lora_state(params))


def _port_trainer(flat):
    spec = get_model_specification_cls("wan", "lora")(device="cpu", transformer_config=TINY,
                                                      transformer_dtype=torch.float32)
    trainer = SFTTrainer(BaseArgs(training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0), spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, flat)
    return trainer


@pytest.mark.parametrize("switch", [None, *SWITCHES], ids=["default", *(s.lower() for s in SWITCHES)])
def test_wan_train_step_matches_jax(switch, monkeypatch):
    flat, conditions, latents, draws, loss, max_loss, grad_norm, grads, updated, initial = _jax_reference()
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    calls = []
    if switch is not None:
        monkeypatch.setenv(switch, "1")
        ref_name = SWITCHES[switch][0]
        plain = getattr(flash_ops, ref_name)
        monkeypatch.setattr(flash_ops, ref_name, lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    trainer = _port_trainer(flat)
    assert trainer.scheduler.shift == 3.0
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    if switch is not None:
        assert len(calls) == SWITCHES[switch][1], calls
    np.testing.assert_allclose(float(out["loss"]), loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), max_loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), grad_norm, atol=ATOL, rtol=0)
    clip = min(1.0, 1.0 / grad_norm)
    module = trainer.transformer.module
    params = dict(module.named_parameters())
    # Every LoRADense of the blocks trains (2 blocks x 10 layers x (A, B)), as in the JAX trainer.
    assert sorted(grads) == sorted(trainer._trainable) and len(grads) == 2 * 10 * 2
    for name in grads:
        port_grad, port_value = params[name].grad, params[name].detach()
        np.testing.assert_allclose(port_grad.numpy(), clip * grads[name], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(port_value.numpy(), updated[name], atol=ATOL, rtol=0, err_msg=name)
        assert not np.allclose(port_value.numpy(), initial[name], atol=1e-7, rtol=0), f"{name} did not move"
    for name, param in params.items():
        if name not in trainer._trainable:
            assert not param.requires_grad and param.grad is None, name


def test_wan_forward_normalises_both_halves_of_the_moments():
    """The moments' mean and log-variance halves are both (x - mean) / std per
    channel before sampling, as the JAX spec does (:222-228)."""
    _, _, latents, *_ = _jax_reference()
    spec = JaxSpec(transformer_config=TINY)
    ref = spec._normalize_moments(*(jnp.asarray(latents[k]) for k in ("latents", "latents_mean", "latents_std")))
    port = get_model_specification_cls("wan", "lora")._normalize_moments(
        *(torch.from_numpy(latents[k]) for k in ("latents", "latents_mean", "latents_std")))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
