"""One CogView4 LoRA step under int8 weight storage against the JAX package's.

The model of test_torch_cogview4_transformer.py (2 blocks, 2 heads of 64,
fp32, JAX's weights, the sinusoidal embeddings handed over) with its frozen
weights stored int8 by each side's trainer (JAX's `apply_int8_storage` on
the frozen tree; the port's `SFTTrainer` under `--layerwise_upcasting_modules
transformer --layerwise_upcasting_storage_dtype int8`), on JAX's draws: its
loss, gradients and updated factors within 1e-4 of JAX's (the two sides run
the same int8 products, and differ by the fp32 order of the other sums), but
a factor whose gradient lies within 1e-5 of 0, where AdamW's first update
lr * g / (|g| + eps) may take the other sign: within 2 lr there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models.cogview4 import CogView4ModelSpecification as JaxSpec
from finetrainers_tpu.models.cogview4.transformer import CogView4Transformer2DModel as JaxCogView4
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxEuler
from finetrainers_tpu.utils.int8 import apply_int8_storage as jax_int8_storage
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models.cogview4 import cogview4_key_map, load_flax_params
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_cogview4_transformer import TINY, jax_embedding, jax_params, unflatten

torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 8, 12)  # (B, 2C, H, W)
TEXT_LEN = 8
ATOL = 1e-4


def _batch():
    rng = np.random.RandomState(11)
    moments = rng.randn(*MOMENTS).astype(np.float32)
    moments[:, MOMENTS[1] // 2:] = -1.0 + 0.5 * moments[:, MOMENTS[1] // 2:]  # log-variance
    ehs = rng.randn(MOMENTS[0], TEXT_LEN, TINY["text_embed_dim"]).astype(np.float32)
    sizes = np.asarray([[1024, 768], [512, 512]], np.float32)
    return {"encoder_hidden_states": ehs}, {"latents": moments, "original_size": sizes, "target_size": sizes,
                                           "crop_coords": np.zeros((2, 2), np.float32)}


def _lora_state(tree):
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return flax_to_torch_state_dict(flat, cogview4_key_map)


@functools.lru_cache(maxsize=None)
def _jax_int8_step():
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    module = JaxCogView4(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32, use_scan=False)
    flat = jax_params(module)
    params = unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    frozen = jax_int8_storage(frozen)
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant", 1e-4), beta1=0.9, beta2=0.95, epsilon=1e-8,
                              weight_decay=1e-4, max_grad_norm=1.0)

    @jax.jit
    def step(trainable, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = JaxEuler().training_sigmas(rng_sigmas, MOMENTS[0], flow_weighting_scheme="none")

        def loss_fn(trainable):
            handle = ModelHandle(module, merge_params(trainable, frozen), dict(spec.transformer_config))
            pred, target, _ = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            return jnp.mean((pred.astype(jnp.float32) - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(4)
    loss, grads, updated = step(trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    b, c2, h, w = MOMENTS
    draws = {"sigmas": np.array(jax.random.uniform(rng_sigmas, (b,), dtype=jnp.float32)),
             "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, 1, h, w)))[:, :, 0],
             "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, h, w), jnp.float32))}
    return dict(flat=flat, conditions=conditions, latents=latents, draws=draws, loss=float(loss),
                grads=_lora_state(grads), updated=_lora_state(updated))


def test_cogview4_lora_step_under_int8_storage_matches_jax(monkeypatch):
    jax_embedding(monkeypatch)
    ref = _jax_int8_step()
    spec = get_model_specification_cls("cogview4", "lora")(device="cpu", transformer_config=TINY,
                                                           transformer_dtype=torch.float32)
    load = spec.load_diffusion_models

    def load_jax_weights():  # JAX's weights go in before the trainer stores them as int8
        models = load()
        load_flax_params(models["transformer"].module, ref["flat"])
        return models

    monkeypatch.setattr(spec, "load_diffusion_models", load_jax_weights)
    trainer = SFTTrainer(BaseArgs(model_name="cogview4", training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0,
                                  flow_weighting_scheme="none", optimizer="adamw", lr=1e-4, lr_scheduler="constant",
                                  beta1=0.9, beta2=0.95, weight_decay=1e-4, epsilon=1e-8, max_grad_norm=1.0,
                                  layerwise_upcasting_modules=["transformer"],
                                  layerwise_upcasting_storage_dtype=torch.int8), spec)
    trainer.prepare()
    module = trainer.transformer.module
    assert module.transformer_blocks[0].attn1.to_q.weight.dtype == torch.int8
    assert module.proj_out.weight.dtype == torch.float32  # skipped: ^proj_out$
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in ref["conditions"].items()},
                             {k: torch.from_numpy(v) for k, v in ref["latents"].items()}, draws=ref["draws"])
    np.testing.assert_allclose(float(out["loss"]), ref["loss"], atol=ATOL, rtol=0)
    params = dict(module.named_parameters())
    assert sorted(ref["grads"]) == sorted(trainer._trainable)
    grad_norm = float(out["grad_norm"])
    for name in ref["grads"]:
        np.testing.assert_allclose(params[name].grad.numpy(), min(1.0, 1.0 / grad_norm) * ref["grads"][name],
                                   atol=ATOL, rtol=0, err_msg=name)
        # AdamW's first update is lr * g / (|g| + eps): where a gradient lies within rounding of 0 its sign, and so
        # the update's, may differ; there the factors agree within 2 lr.
        settled = np.abs(ref["grads"][name]) > 1e-5
        got = params[name].detach().numpy()
        np.testing.assert_allclose(got[settled], ref["updated"][name][settled], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got, ref["updated"][name], atol=ATOL + 2 * 1e-4, rtol=0, err_msg=name)
