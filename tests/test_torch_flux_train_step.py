"""The Flux LoRA training slice: one `SFTTrainer.train_step` of the port on the
Flux spec against JAX's `value_and_grad` of the same LoRA flow-matching loss,
and the LoRA and full-rank exports against JAX's files.

Both sides run the tiny Flux model in fp32 (2 dual and 2 single blocks, 2
heads of 64, RoPE axes (16, 24, 24)) with the JAX weights through
`load_flax_params` (nonzero `lora_b`, noise on every bias and norm scale).
The batch is seeded image moments (2, 8, 8, 12) -> 4 x 6 packed tokens per
sample, 16 text tokens and pooled states. The JAX step is
`_build_train_step`'s: logit-normal sigmas from Flux's
`FlowMatchEulerScheduler(use_dynamic_shifting=True)`,
`FluxModelSpecification.forward` (guidance 1.0 x 1000), the logit-normal
loss weighting, optax AdamW with the trainer's defaults, attention under
JAX's `_native_math` (the same function as its `auto`, whose backward
compiles ~18 s longer here; the port runs `auto`). Its random draws
(sigma density, posterior sample, noise) are rebuilt with the same keys and
handed to the port. The port's sinusoidal time embedding takes JAX's values
(the packages' fp32 `exp` differ by an ulp; test_torch_flux_transformer.py
holds that stage on its own). Compared at atol 1e-4: loss, max_loss, grad
norm, every LoRA gradient (clipped in place, so against JAX's times the clip
factor) and every LoRA factor after the update. Every LoRA layer trains,
the single blocks' `proj_mlp`/`proj_out` and the feed-forwards too, as in
the JAX trainer (ROADMAP.md section 3, finding 1).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from safetensors.numpy import load_file as np_load_file

from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models.flux import FluxModelSpecification as JaxSpec
from finetrainers_tpu.models.flux import FluxTransformer2DModel as JaxFlux
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params, unflatten_params
from finetrainers_tpu.ops import attention_provider as jax_attention_provider
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, apply_lora_to_module_params, extract_lora_state_dict
from finetrainers_tpu_torch.models.flux import flux_key_map, load_flax_params
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle as PortHandle
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_flux_transformer import TINY, jax_embedding, jax_flux_params, unflatten

torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 8, 12)  # (B, 2C, H, W)
TEXT_LEN = 16
ATOL = 1e-4
# The flux_dev example's --target_modules.
TARGETS = "transformer_blocks.*(to_q|to_k|to_v|to_out.0|add_q_proj|add_k_proj|add_v_proj|to_add_out)"
CONFIG = {"r": RANK, "lora_alpha": ALPHA, "target_modules": TARGETS}


def _batch():
    rng = np.random.RandomState(11)
    b, c2 = MOMENTS[:2]
    moments = rng.randn(*MOMENTS).astype(np.float32)
    moments[:, c2 // 2:] = -1.0 + 0.5 * moments[:, c2 // 2:]  # log-variance
    mask = np.zeros((b, TEXT_LEN), np.int32)
    mask[0, :] = 1
    mask[1, :5] = 1  # padded caption: computed, never used in attention
    conditions = {"encoder_hidden_states": rng.randn(b, TEXT_LEN, 32).astype(np.float32),
                  "encoder_attention_mask": mask,
                  "pooled_projections": rng.randn(b, 24).astype(np.float32)}
    return conditions, {"latents": moments}


def _lora_state(tree):
    """A flax tree's LoRA leaves by peft name and layout."""
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return flax_to_torch_state_dict(flat, flux_key_map)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's train step on the tiny Flux spec: its loss, max_loss, grad norm,
    gradients and LoRA factors before and after the update (by peft name), and
    its draws."""
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    module = JaxFlux(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32)
    flat = jax_flux_params(module)
    params = unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = JaxScheduler(use_dynamic_shifting=True)  # Flux's (load_diffusion_models)
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant", 1e-4), beta1=0.9, beta2=0.95, epsilon=1e-8,
                              weight_decay=1e-4, max_grad_norm=1.0)
    batch = MOMENTS[0]

    @jax.jit
    def step(trainable, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = scheduler.training_sigmas(rng_sigmas, batch, flow_weighting_scheme="logit_normal")

        def loss_fn(trainable):
            handle = ModelHandle(module, merge_params(trainable, frozen), dict(spec.transformer_config))
            pred, target, sigmas_out = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            w = jax_loss_weighting("logit_normal", sigmas=sigmas_out).reshape(-1, 1, 1, 1)
            per_sample = w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2
            return jnp.mean(per_sample), jnp.max(jnp.mean(per_sample, axis=(1, 2, 3)))

        (loss, max_loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, max_loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(2)
    with jax_attention_provider("_native_math"):
        loss, max_loss, grad_norm, grads, updated = step(trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    b, c2, h, w = MOMENTS
    draws = {
        "sigmas": np.array(jax.random.normal(rng_sigmas, (batch,), jnp.float32)),
        "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, 1, h, w), jnp.float32)),
        "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, h, w), jnp.float32)),
    }
    return (flat, conditions, latents, draws, float(loss), float(max_loss), float(grad_norm), _lora_state(grads),
            _lora_state(updated), _lora_state(params))


def _port_trainer(flat, **args):
    spec = get_model_specification_cls("flux", "lora")(device="cpu", transformer_config=TINY,
                                                       transformer_dtype=torch.float32)
    trainer = SFTTrainer(BaseArgs(training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0,
                                  flow_weighting_scheme="logit_normal", **args), spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, flat)
    return trainer


def test_flux_train_step_matches_jax(monkeypatch):
    jax_embedding(monkeypatch)
    flat, conditions, latents, draws, loss, max_loss, grad_norm, grads, updated, initial = _jax_reference()
    trainer = _port_trainer(flat, target_modules=CONFIG["target_modules"])
    assert trainer.scheduler.use_dynamic_shifting
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    np.testing.assert_allclose(float(out["loss"]), loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), max_loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), grad_norm, atol=ATOL, rtol=0)
    clip = min(1.0, 1.0 / grad_norm)
    params = dict(trainer.transformer.module.named_parameters())
    # Every LoRA layer trains: 2 dual blocks x 12 (q, k, v, out, the text's 4, 2 feed-forwards x 2) and
    # 2 single blocks x 5 (q, k, v, proj_mlp, proj_out), each with A and B, as in the JAX trainer.
    assert sorted(grads) == sorted(trainer._trainable) and len(grads) == (2 * 12 + 2 * 5) * 2
    assert any(".proj_mlp." in name for name in grads) and any("ff_context" in name for name in grads)
    for name in grads:
        port_grad, port_value = params[name].grad, params[name].detach()
        np.testing.assert_allclose(port_grad.numpy(), clip * grads[name], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(port_value.numpy(), updated[name], atol=ATOL, rtol=0, err_msg=name)
        assert not np.allclose(port_value.numpy(), initial[name], atol=1e-7, rtol=0), f"{name} did not move"
    for name, param in params.items():
        if name not in trainer._trainable:
            assert not param.requires_grad and param.grad is None, name


def test_lora_and_full_rank_exports_equal_jax(tmp_path):
    """The adapter and the full-rank model the port's spec writes have the keys,
    layouts and values of JAX's; the port's runner loads JAX's adapter, with
    JAX's flax names too, into a fresh Flux model."""
    flat = _jax_reference()[0]
    jax_spec = JaxSpec(transformer_config=TINY)
    lora_flat = {k: v for k, v in flat.items() if k.endswith(("lora_a", "lora_b"))}
    jax_spec._save_lora_weights(str(tmp_path / "jax"), lora_flat, CONFIG)
    spec = get_model_specification_cls("flux", "lora")(device="cpu", transformer_config=TINY,
                                                       transformer_dtype=torch.float32, lora_rank=RANK,
                                                       lora_alpha=ALPHA)
    module = spec.load_diffusion_models()["transformer"].module
    load_flax_params(module, flat)
    spec._save_lora_weights(str(tmp_path / "port"), extract_lora_state_dict(module), CONFIG)
    ref, got = (np_load_file(str(tmp_path / side / LORA_WEIGHTS_NAME)) for side in ("jax", "port"))
    assert sorted(got) == sorted(ref) and len(ref) == (2 * 12 + 2 * 5) * 2
    assert "transformer.single_transformer_blocks.1.proj_mlp.lora_A.weight" in ref
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for state in (ref, lora_flat):  # peft names, and the JAX package's flax names through the key map
        fresh = spec.load_diffusion_models()["transformer"].module
        apply_lora_to_module_params(fresh, {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                                    key_map=spec.transformer_key_map)
        for name, value in extract_lora_state_dict(fresh).items():
            np.testing.assert_array_equal(value.numpy(), ref["transformer." + name], err_msg=name)

    jax_handle = ModelHandle(JaxFlux(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32),
                             unflatten_params(flat), dict(jax_spec.transformer_config))
    jax_spec._save_model(str(tmp_path / "jax_full"), jax_handle)
    spec._save_model(str(tmp_path / "port_full"), PortHandle(module, dict(spec.transformer_config)))
    name = "diffusion_pytorch_model.safetensors"
    ref, got = (np_load_file(str(tmp_path / side / name)) for side in ("jax_full", "port_full"))
    assert sorted(got) == sorted(ref) and not any("lora" in key for key in ref)
    assert "time_text_embed.guidance_embedder.linear_1.weight" in ref
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    configs = [json.loads((tmp_path / side / "config.json").read_text()) for side in ("jax_full", "port_full")]
    assert configs[0] == configs[1] and configs[1]["_class_name"] == "FluxTransformer2DModel"
