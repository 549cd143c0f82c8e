"""The training slice as a whole: one `SFTTrainer.train_step` of the port against
JAX's `value_and_grad` of the same LoRA flow-matching loss.

Both sides run the tiny LTX spec in fp32 (a tiny VAE config on both, which
sets the same RoPE interpolation scale), with the JAX transformer weights
through `load_flax_params` (nonzero `lora_b`, noise on every bias, norm scale
and `scale_shift_table`). The JAX step is `_build_train_step`'s: sigmas from
`FlowMatchEulerScheduler.training_sigmas`, `LTXVideoModelSpecification.forward`,
the unweighted ("none") flow-matching loss, optax `get_optimizer("adamw", ...)`
with the trainer's defaults (lr 1e-4, betas 0.9/0.95, weight decay 1e-4, eps
1e-8, max_grad_norm 1.0). Its random draws (sigma density, posterior sample,
noise, first-frame coin and sigma) are rebuilt on the test side with the same
keys and handed to the port. The seed is chosen so that the first-frame coin
comes up, which exercises stochastic first-frame conditioning. Compared at
atol 1e-4: loss, max_loss, grad norm, every LoRA gradient (the port clips its
gradients in place, so against JAX's times the clip factor) and every LoRA
factor after the update; with no remat, per-block "full" remat and "block_skip".
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu.functional import diffusion as jax_diffusion
from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models.autoencoders import AutoencoderConfig as JaxVAEConfig
from finetrainers_tpu.models.autoencoders import sample_from_moments as jax_sample_from_moments
from finetrainers_tpu.models.ltx_video import LTXVideoModelSpecification as JaxSpec
from finetrainers_tpu.models.ltx_video import LTXVideoTransformer3DModel as JaxLTX
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.functional import diffusion
from finetrainers_tpu_torch.lora import lora_mask, split_params as port_split_params
from finetrainers_tpu_torch.models.autoencoders import AutoencoderConfig, sample_from_moments
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.ltx_video import load_flax_params
from finetrainers_tpu_torch.models.ltx_video.transformer import LTXAttention
from finetrainers_tpu_torch.models.ltx_video.weights import ltx_key_map
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.schedulers import FlowMatchEulerScheduler
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=8,
            cross_attention_dim=16, num_layers=2, caption_channels=32)
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
              spatial_downsample=(True,), temporal_downsample=(True,))
RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 3, 2, 4)  # (B, 2C, F, H, W): 24 tokens per sample
ATOL = 1e-4


def _first_seed_with_coin_up():
    for seed in range(200):
        rng_fwd = jax.random.split(jax.random.PRNGKey(seed))[1]
        if bool(jax.random.bernoulli(jax.random.split(rng_fwd, 4)[2], JaxSpec.first_frame_conditioning_p)):
            return seed
    raise AssertionError("no seed below 200 raises the first-frame coin")


def _jax_params(module):
    params = drawn_params(module, jnp.zeros((1, 8, 4)), jnp.zeros((1, 16, 32)),
                          jnp.zeros((1,)), num_frames=2, height=2, width=2)
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
    b, c2, f, h, w = MOMENTS
    moments = rng.randn(*MOMENTS).astype(np.float32)
    moments[:, c2 // 2:] = -1.0 + 0.5 * moments[:, c2 // 2:]  # log-variance
    mask = np.zeros((b, 16), np.int32)
    mask[0, :16] = 1
    mask[1, :5] = 1  # padded caption
    conditions = {"encoder_hidden_states": rng.randn(b, 16, 32).astype(np.float32), "encoder_attention_mask": mask}
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
    """JAX's train step on the tiny spec: its loss, max_loss, grad norm,
    gradients and LoRA factors before and after the update (by peft name), and
    its draws."""
    seed = _first_seed_with_coin_up()
    spec = JaxSpec(transformer_config=TINY, vae_config=JaxVAEConfig(**VAE_KW), lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    module = JaxLTX(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32)
    flat = _jax_params(module)
    params = _unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = JaxScheduler()
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
            w = jax_loss_weighting("none", sigmas=sigmas_out).reshape(-1, 1, 1)
            per_sample = w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2
            return jnp.mean(per_sample), jnp.max(jnp.mean(per_sample, axis=(1, 2)))

        (loss, max_loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, max_loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(seed)
    loss, max_loss, grad_norm, grads, updated = step(trainable, rng)
    # The same draws, rebuilt with the step's keys (training_sigmas' "none"
    # density; the four draws of spec.forward).
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise, rng_ff, rng_ffs = jax.random.split(rng_fwd, 4)
    b, c2, f, h, w = MOMENTS
    draws = {
        "sigmas": np.array(jax.random.uniform(rng_sigmas, (batch,), jnp.float32)),
        "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, f, h, w), jnp.float32)),
        "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, f, h, w), jnp.float32)),
        "first_frame": np.array(jax.random.bernoulli(rng_ff, JaxSpec.first_frame_conditioning_p)),
        "first_frame_u": np.array(jax.random.uniform(rng_ffs, (batch,))),
    }
    assert draws["first_frame"]

    def lora_state(tree):  # peft names and layouts
        flat_tree = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
                     if k.endswith(("lora_a", "lora_b"))}
        return flax_to_torch_state_dict(flat_tree, ltx_key_map)

    return (flat, conditions, latents, draws, float(loss), float(max_loss), float(grad_norm), lora_state(grads),
            lora_state(updated), lora_state(params))


def _port_trainer(flat, remat, **kw):
    spec = get_model_specification_cls("ltx_video", "lora")(
        device="cpu", transformer_config=TINY, vae_config=AutoencoderConfig(**VAE_KW),
        transformer_dtype=torch.float32, vae_dtype=torch.float32)
    args = BaseArgs(training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0,
                    gradient_checkpointing=remat is not None, gradient_checkpointing_type=remat or "full", **kw)
    trainer = SFTTrainer(args, spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, flat)
    return trainer


@pytest.mark.parametrize("remat", [None, "full", "block_skip"], ids=["no_remat", "full_remat", "block_skip_remat"])
def test_train_step_matches_jax(remat):
    flat, conditions, latents, draws, loss, max_loss, grad_norm, grads, updated, initial = _jax_reference()
    trainer = _port_trainer(flat, remat)
    module = trainer.transformer.module
    assert module.gradient_checkpointing == remat
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    np.testing.assert_allclose(float(out["loss"]), loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), max_loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), grad_norm, atol=ATOL, rtol=0)
    clip = min(1.0, 1.0 / grad_norm)
    params = dict(module.named_parameters())
    assert sorted(grads) == sorted(trainer._trainable) and len(grads) == 2 * 2 * 10  # 2 blocks x 10 layers x (A, B)
    for name in grads:
        port_grad, port_value = params[name].grad, params[name].detach()
        np.testing.assert_allclose(port_grad.numpy(), clip * grads[name], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(port_value.numpy(), updated[name], atol=ATOL, rtol=0, err_msg=name)
        assert not np.allclose(port_value.numpy(), initial[name], atol=1e-7, rtol=0), f"{name} did not move"
    for name, param in params.items():
        if name not in trainer._trainable:
            assert not param.requires_grad and param.grad is None, name


def test_train_loop_advances_the_state(tmp_path):
    flat, conditions, latents, draws, *_ = _jax_reference()
    trainer = _port_trainer(flat, None, output_dir=str(tmp_path))
    trainer.args.train_steps = 2
    batch = ({k: torch.from_numpy(v) for k, v in conditions.items()},
             {k: torch.from_numpy(v) for k, v in latents.items()})
    state = trainer.train([batch] * 3)
    assert state.step == 2 and state.observed_data_samples == 2 * MOMENTS[0] and state.log_steps == [1, 2]
    assert all(np.isfinite(state.global_avg_losses)) and len(state.global_max_losses) == 2
    assert trainer.optimizer.count == 2
    assert trainer.checkpointer.all_steps() == [2]  # the save at the end of the run
    with pytest.raises(ValueError, match="dataset_config"):  # run() trains from a dataset, train() from batches
        trainer.run()


def test_fused_qkv_lora_grads_match_separate_layers():
    """The fused QKV path (one wide matmul, one stacked lora_A) gives the LoRA
    factors the gradients of three separate LoRADense layers; frozen weights get none."""
    attn = LTXAttention(16, 2, 8, lora_rank=4, lora_alpha=8.0, dtype=torch.float32)
    init_parameters_(attn, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in (attn.to_q, attn.to_k, attn.to_v):
            layer.lora_B.weight.normal_(0.0, 0.5, generator=gen)
    trainable, _ = port_split_params(attn, lora_mask(attn))
    x = torch.randn(2, 6, 16, generator=gen)
    weights = [torch.randn(2, 6, 16, generator=gen) for _ in range(3)]

    def grads(outputs):
        loss = sum((o * g).sum() for o, g in zip(outputs, weights))
        return torch.autograd.grad(loss, list(trainable.values()), allow_unused=True)

    fused = grads(attn._fused_qkv(x))
    separate = grads((attn.to_q(x), attn.to_k(x), attn.to_v(x)))
    for name, a, b in zip(trainable, fused, separate):
        if ".to_out." in name:
            assert a is None and b is None
            continue
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)
    assert not any(p.requires_grad for n, p in attn.named_parameters() if n not in trainable)


@pytest.mark.parametrize("scheme", ["none", "logit_normal", "mode", "sigma_sqrt", "cosmap"])
def test_training_sigmas_and_loss_weights_match_jax(scheme):
    """training_sigmas with JAX's raw draw handed over, the flow shift and the
    loss weighting, per weighting scheme; atol 1e-6 (fp32 transcendental
    functions of two libraries)."""
    key = jax.random.PRNGKey(3)
    sample = jax.random.normal if scheme == "logit_normal" else jax.random.uniform
    draw = np.array(sample(key, (5,), jnp.float32))
    ref = JaxScheduler(shift=1.0).training_sigmas(key, 5, flow_weighting_scheme=scheme)
    sigmas = FlowMatchEulerScheduler(shift=1.0).training_sigmas(5, flow_weighting_scheme=scheme,
                                                                draw=torch.from_numpy(draw))
    np.testing.assert_allclose(sigmas.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    shifted = diffusion.default_flow_shift(sigmas, 3.0)
    np.testing.assert_allclose(shifted.numpy(), np.asarray(jax_diffusion.default_flow_shift(ref, 3.0)), atol=1e-6)
    np.testing.assert_allclose(diffusion.compute_loss_weighting(scheme, sigmas=shifted).numpy(),
                               np.asarray(jax_loss_weighting(scheme, sigmas=jnp.asarray(shifted.numpy()))),
                               rtol=1e-6, atol=1e-6)


def test_sample_from_moments_matches_jax():
    moments = np.random.RandomState(0).randn(2, 8, 3, 2, 2).astype(np.float32) * 3.0  # log-variance clamps hit
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (2, 4, 3, 2, 2), jnp.float32))
    ref = jax_sample_from_moments(jnp.asarray(moments), key)
    out = sample_from_moments(torch.from_numpy(moments), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)
