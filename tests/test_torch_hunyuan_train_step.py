"""The HunyuanVideo LoRA training slice: one `SFTTrainer.train_step` of the port
on the HunyuanVideo spec against JAX's `value_and_grad` of the same LoRA
flow-matching loss, and the LoRA and full-rank exports against JAX's files.

Both sides run the tiny HunyuanVideo model in fp32 (2 dual, 2 single and 2
refiner blocks, 2 heads of 64, RoPE axes (16, 24, 24)) with the JAX weights
through `load_flax_params` (nonzero `lora_b`, noise on every bias and norm
scale). The batch is seeded video moments (2, 8, 3, 8, 12) -> 3 x 4 x 6 = 72
video tokens per sample, 16 text tokens with valid lengths [16, 5], and
pooled states. The JAX step is `_build_train_step`'s: logit-normal sigmas
from the spec's `FlowMatchEulerScheduler(shift=7.0)`,
`HunyuanVideoModelSpecification.forward` (scaling 0.476986, guidance 1.0 x
1000), the logit-normal loss weighting, optax AdamW with the modal_labs_dissolve
example's settings at a constant rate. Its random draws (sigma density, posterior sample, noise)
are rebuilt with the same keys and handed to the port. The port's sinusoidal
time embedding takes JAX's values (the packages' fp32 `exp` differ by an ulp;
test_torch_flux_transformer.py holds that stage on its own). Compared at
atol 1e-4: loss, max_loss, grad norm, every LoRA gradient (clipped in place,
so against JAX's times the clip factor) and every LoRA factor after the
update. Every LoRA layer trains, the refiner's too, though the example's
`--target_modules` selects only the 60 blocks' attention, as in the JAX
trainer (ROADMAP.md section 3, finding 1).
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
from finetrainers_tpu.models.hunyuan_video import HunyuanVideoModelSpecification as JaxSpec
from finetrainers_tpu.models.hunyuan_video import HunyuanVideoTransformer3DModel as JaxHunyuan
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params, unflatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, apply_lora_to_module_params, extract_lora_state_dict
from finetrainers_tpu_torch.models.hunyuan_video import hunyuan_key_map, load_flax_params
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle as PortHandle
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_hunyuan_transformer import TINY, jax_embedding, jax_hunyuan_params, unflatten

torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 3, 8, 12)  # (B, 2C, F, H, W)
TEXT_LEN = 16
ATOL = 1e-4
# The modal_labs_dissolve example's --target_modules.
TARGETS = "(transformer_blocks|single_transformer_blocks).*(to_q|to_k|to_v|to_out.0)"
CONFIG = {"r": RANK, "lora_alpha": ALPHA, "target_modules": TARGETS}
# LoRA layers: a dual block's 12 (q, k, v, out, the text's 4, two feed-forwards of 2), a single block's 5
# (q, k, v, proj_mlp, proj_out), a refiner block's 6 (q, k, v, out, the feed-forward's 2).
LORA_LAYERS = 2 * 12 + 2 * 5 + 2 * 6


def _batch():
    rng = np.random.RandomState(11)
    b, c2 = MOMENTS[:2]
    moments = rng.randn(*MOMENTS).astype(np.float32)
    moments[:, c2 // 2:] = -1.0 + 0.5 * moments[:, c2 // 2:]  # log-variance
    mask = np.zeros((b, TEXT_LEN), np.int32)
    mask[0, :] = 1
    mask[1, :5] = 1
    conditions = {"encoder_hidden_states": rng.randn(b, TEXT_LEN, 32).astype(np.float32),
                  "encoder_attention_mask": mask,
                  "pooled_projections": rng.randn(b, 24).astype(np.float32)}
    return conditions, {"latents": moments}


def _lora_state(tree):
    """A flax tree's LoRA leaves by peft name and layout."""
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return flax_to_torch_state_dict(flat, hunyuan_key_map)


def _optimizer_args():
    """The example's AdamW (train.sh's optimizer_cmd) at a constant rate: its
    300-step warmup would start the first update at a rate of 0."""
    return dict(optimizer="adamw", lr=3e-5, lr_scheduler="constant", beta1=0.9, beta2=0.99, weight_decay=1e-4,
                epsilon=1e-8, max_grad_norm=1.0)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's train step on the tiny spec: its loss, max_loss, grad norm,
    gradients and LoRA factors before and after the update (by peft name),
    and its draws."""
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    module = JaxHunyuan(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32)
    flat = jax_hunyuan_params(module)
    params = unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = JaxScheduler(shift=7.0)  # HunyuanVideo's (load_diffusion_models)
    opt = _optimizer_args()
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant", opt["lr"]), beta1=0.9, beta2=0.99, epsilon=1e-8,
                              weight_decay=1e-4, max_grad_norm=1.0)
    batch = MOMENTS[0]

    @jax.jit
    def step(trainable, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = scheduler.training_sigmas(rng_sigmas, batch, flow_weighting_scheme="logit_normal")

        def loss_fn(trainable):
            handle = ModelHandle(module, merge_params(trainable, frozen), dict(spec.transformer_config))
            pred, target, sigmas_out = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            w = jax_loss_weighting("logit_normal", sigmas=sigmas_out).reshape(-1, 1, 1, 1, 1)
            per_sample = w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2
            return jnp.mean(per_sample), jnp.max(jnp.mean(per_sample, axis=(1, 2, 3, 4)))

        (loss, max_loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, max_loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(2)
    loss, max_loss, grad_norm, grads, updated = step(trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    b, c2, f, h, w = MOMENTS
    draws = {
        "sigmas": np.array(jax.random.normal(rng_sigmas, (batch,), jnp.float32)),
        "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, f, h, w), jnp.float32)),
        "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, f, h, w), jnp.float32)),
    }
    return (flat, conditions, latents, draws, float(loss), float(max_loss), float(grad_norm), _lora_state(grads),
            _lora_state(updated), _lora_state(params))


def _port_trainer(flat, **args):
    spec = get_model_specification_cls("hunyuan_video", "lora")(device="cpu", transformer_config=TINY,
                                                                transformer_dtype=torch.float32)
    trainer = SFTTrainer(BaseArgs(training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0,
                                  flow_weighting_scheme="logit_normal", **_optimizer_args(), **args), spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, flat)
    return trainer


def test_hunyuan_train_step_matches_jax(monkeypatch):
    jax_embedding(monkeypatch)
    flat, conditions, latents, draws, loss, max_loss, grad_norm, grads, updated, initial = _jax_reference()
    trainer = _port_trainer(flat, target_modules=CONFIG["target_modules"])
    assert trainer.scheduler.shift == 7.0
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    np.testing.assert_allclose(float(out["loss"]), loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), max_loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), grad_norm, atol=ATOL, rtol=0)
    clip = min(1.0, 1.0 / grad_norm)
    params = dict(trainer.transformer.module.named_parameters())
    assert sorted(grads) == sorted(trainer._trainable) and len(grads) == LORA_LAYERS * 2
    assert any(".token_refiner.refiner_blocks_1.ff.net.2." in name for name in grads)
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
    layouts and values of JAX's (the refiner's under
    `context_embedder.token_refiner.refiner_blocks_<i>`, as JAX writes them);
    the port's runner loads JAX's adapter, with JAX's flax names too, into a
    fresh HunyuanVideo model."""
    flat = _jax_reference()[0]
    jax_spec = JaxSpec(transformer_config=TINY)
    lora_flat = {k: v for k, v in flat.items() if k.endswith(("lora_a", "lora_b"))}
    jax_spec._save_lora_weights(str(tmp_path / "jax"), lora_flat, CONFIG)
    spec = get_model_specification_cls("hunyuan_video", "lora")(device="cpu", transformer_config=TINY,
                                                                transformer_dtype=torch.float32, lora_rank=RANK,
                                                                lora_alpha=ALPHA)
    module = spec.load_diffusion_models()["transformer"].module
    load_flax_params(module, flat)
    spec._save_lora_weights(str(tmp_path / "port"), extract_lora_state_dict(module), CONFIG)
    ref, got = (np_load_file(str(tmp_path / side / LORA_WEIGHTS_NAME)) for side in ("jax", "port"))
    assert sorted(got) == sorted(ref) and len(ref) == LORA_LAYERS * 2
    assert "transformer.context_embedder.token_refiner.refiner_blocks_0.attn.to_q.lora_A.weight" in ref
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for state in (ref, lora_flat):  # peft names, and the JAX package's flax names through the key map
        fresh = spec.load_diffusion_models()["transformer"].module
        apply_lora_to_module_params(fresh, {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                                    key_map=spec.transformer_key_map)
        for name, value in extract_lora_state_dict(fresh).items():
            np.testing.assert_array_equal(value.numpy(), ref["transformer." + name], err_msg=name)

    jax_handle = ModelHandle(JaxHunyuan(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32),
                             unflatten_params(flat), dict(jax_spec.transformer_config))
    jax_spec._save_model(str(tmp_path / "jax_full"), jax_handle)
    spec._save_model(str(tmp_path / "port_full"), PortHandle(module, dict(spec.transformer_config)))
    name = "diffusion_pytorch_model.safetensors"
    ref, got = (np_load_file(str(tmp_path / side / name)) for side in ("jax_full", "port_full"))
    assert sorted(got) == sorted(ref) and not any("lora" in key for key in ref)
    assert "context_embedder.time_text_embed.text_embedder.linear_1.weight" in ref
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    configs = [json.loads((tmp_path / side / "config.json").read_text()) for side in ("jax_full", "port_full")]
    assert configs[0] == configs[1] and configs[1]["_class_name"] == "HunyuanVideoTransformer3DModel"
