"""The CogVideoX LoRA training slice, the zoo's one DDIM objective: the
scheduler's alpha-bar table, the sigma draw and the fp32 timestep
truncation, the spec's training forward, and one `SFTTrainer.train_step`
of the port against JAX's `value_and_grad` + optax.

Both sides run the tiny CogVideoX model of test_torch_cogvideox_transformer.py
(2 blocks, 2 heads of 64, the 5B's 3D RoPE) in fp32 with JAX's weights through
`load_flax_params` (nonzero `lora_b`). The batch is seeded frames-first
moments (2, 3, 8, 8, 12) -> 3 x 4 x 6 = 72 video tokens per sample and 8
text slots. The JAX step is the trainer's (`_build_train_step`, :239-279):
uniform sigmas from `CogVideoXDDIMScheduler` whatever the weighting scheme
(the example's is logit-normal), `CogVideoXModelSpecification.forward`
(scaling 0.7, DDIM noising at t = int32(sigma * 1000) in fp32, the x0
estimate against the latents), the weights 1 / (1 - alpha_bar[t]), optax
AdamW with the crush_smol example's settings at a constant rate. Its draws
(the uniform sigma draw, the posterior sample, the noise) are rebuilt with
the same keys and handed to the port. The sinusoidal time embedding takes
JAX's values. Compared at atol 1e-4 (loss scaled by weights up to 393, so
relative 1e-4 on the loss): loss, max_loss, grad norm, every LoRA gradient
(clipped in place, so against JAX's times the clip factor) and every LoRA
factor after the update; the table and the truncated timesteps exactly.
"""

import functools

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
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import CogVideoXDDIMScheduler as JaxDDIM
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models.cogvideox import cogvideox_key_map, load_flax_params
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle as PortHandle
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.schedulers import CogVideoXDDIMScheduler
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_cogvideox_transformer import TINY, jax_embedding, jax_params, unflatten

torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0
MOMENTS = (2, 3, 8, 8, 12)  # (B, F, 2C, H, W), frames first
TEXT_LEN = 8
ATOL = 1e-4
LORA_LAYERS = 2 * 6  # q, k, v, out and the feed-forward's 2, per block
TARGETS = "(transformer_blocks|single_transformer_blocks).*(to_q|to_k|to_v|to_out.0)"  # the example's


def _batch():
    rng = np.random.RandomState(11)
    b, f, c2 = MOMENTS[:3]
    moments = rng.randn(*MOMENTS).astype(np.float32)
    moments[:, :, c2 // 2:] = -1.0 + 0.5 * moments[:, :, c2 // 2:]  # log-variance
    mask = np.zeros((b, TEXT_LEN), np.int32)
    mask[0, :] = 1
    mask[1, :3] = 1
    ehs = rng.randn(b, TEXT_LEN, 32).astype(np.float32) * mask[..., None]
    return {"encoder_hidden_states": ehs, "encoder_attention_mask": mask}, {"latents": moments}


def _lora_state(tree):
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return flax_to_torch_state_dict(flat, cogvideox_key_map)


def _optimizer_args():
    """The example's AdamW (train.sh's optimizer_cmd) at a constant rate: its
    300-step warmup would start the first update at a rate of 0."""
    return dict(optimizer="adamw", lr=5e-5, lr_scheduler="constant", beta1=0.9, beta2=0.99, weight_decay=1e-4,
                epsilon=1e-8, max_grad_norm=1.0)


def _jax_draws(rng):
    """The trainer's split (sigma key, forward key) and the spec's (posterior key, noise key), as draws."""
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    b, f, c2, h, w = MOMENTS
    return {
        "sigmas": np.array(jax.random.uniform(rng_sigmas, (b,), dtype=jnp.float32)),
        "posterior": np.array(jax.random.normal(rng_post, (b, f, c2 // 2, h, w))),
        "noise": np.array(jax.random.normal(rng_noise, (b, f, c2 // 2, h, w), jnp.float32)),
    }


def _jax_spec():
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    return spec


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's train step on the tiny spec: loss, max_loss, grad norm, gradients
    and LoRA factors before and after the update (by peft name), its forward's
    pred and target, and its draws."""
    spec = _jax_spec()
    module = JaxCogVideoX(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32, use_scan=False)
    flat = jax_params(module, "rope_5b")
    params = unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = spec._scheduler
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
            timesteps = jnp.clip((sigmas_out * scheduler.num_train_timesteps).astype(jnp.int32), 0,
                                 scheduler.num_train_timesteps - 1)
            w = jax_loss_weighting("logit_normal", alphas=scheduler.alphas[timesteps]).reshape(-1, 1, 1, 1, 1)
            per_sample = w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2
            return jnp.mean(per_sample), (jnp.max(jnp.mean(per_sample, axis=(1, 2, 3, 4))), pred, target, sigmas)

        (loss, (max_loss, pred, target, sigmas)), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return (loss, max_loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates), pred,
                target, sigmas)

    rng = jax.random.PRNGKey(2)
    loss, max_loss, grad_norm, grads, updated, pred, target, sigmas = step(trainable, rng)
    return dict(flat=flat, conditions=conditions, latents=latents, draws=_jax_draws(rng), loss=float(loss),
                max_loss=float(max_loss), grad_norm=float(grad_norm), grads=_lora_state(grads),
                updated=_lora_state(updated), initial=_lora_state(params), pred=np.asarray(pred),
                target=np.asarray(target), sigmas=np.array(sigmas))


def _port_spec():
    return get_model_specification_cls("cogvideox", "lora")(device="cpu", transformer_config=TINY,
                                                            transformer_dtype=torch.float32, lora_rank=RANK,
                                                            lora_alpha=ALPHA)


def test_alphas_cumprod_equal_jax():
    """Scaled-linear betas, the SNR shift 3.0 and the zero-terminal-SNR rescale in
    float64, held as fp32: bit-equal to JAX's table; alpha_bar[999] = 0 and the
    loss weight 1 / (1 - alpha_bar[0]) is ~393."""
    ours, ref = CogVideoXDDIMScheduler(), JaxDDIM()
    assert ours.alphas_cumprod.dtype == torch.float32
    np.testing.assert_array_equal(ours.alphas_cumprod.numpy(), np.asarray(ref.alphas_cumprod))
    np.testing.assert_array_equal(ours.sigmas.numpy(), np.asarray(ref.sigmas))
    assert float(ours.alphas[-1]) == 0.0 and 392 < 1.0 / (1.0 - float(ours.alphas[0])) < 394
    odd = CogVideoXDDIMScheduler(snr_shift_scale=1.0, rescale_betas_zero_snr=False)
    np.testing.assert_array_equal(odd.alphas_cumprod.numpy(),
                                  np.asarray(JaxDDIM(snr_shift_scale=1.0, rescale_betas_zero_snr=False).alphas_cumprod))


@pytest.mark.parametrize("scheme", ["none", "logit_normal"])
def test_training_sigmas_are_uniform_whatever_the_scheme_and_truncate_in_fp32(scheme):
    """`training_sigmas` from a handed uniform draw gives JAX's sigmas under any
    weighting scheme (JAX :142-145 ignores it); the timesteps clip(int32(sigma *
    1000)) are formed in fp32 as JAX forms them, which for 5 of the 1000 table
    entries is t - 1 (float64 would give t back at every entry)."""
    rng = jax.random.PRNGKey(5)
    draw = np.array(jax.random.uniform(rng, (64,), dtype=jnp.float32))
    ref = np.asarray(JaxDDIM().training_sigmas(rng, 64, flow_weighting_scheme=scheme))
    ours = CogVideoXDDIMScheduler()
    got = ours.training_sigmas(64, flow_weighting_scheme=scheme, draw=torch.from_numpy(draw))
    np.testing.assert_array_equal(got.numpy(), ref)
    table = JaxDDIM().sigmas
    ref_t = np.asarray(jnp.clip((table * 1000).astype(jnp.int32), 0, 999))
    got_t = ours.timesteps(ours.sigmas).numpy()
    np.testing.assert_array_equal(got_t, ref_t)
    assert (got_t != np.arange(999, -1, -1)).sum() == 5
    generated = ours.training_sigmas(4, generator=torch.Generator().manual_seed(0))
    assert generated.shape == (4,) and bool(((generated >= 0) & (generated < 1)).all())


def test_spec_forward_matches_jax(monkeypatch):
    """`CogVideoXModelSpecification.forward` with JAX's sigmas and draws: pred
    (the x0 estimate) and target (the scaled latent sample) against JAX's."""
    jax_embedding(monkeypatch)
    ref = _jax_reference()
    spec = _port_spec()
    module = spec.load_diffusion_models()["transformer"].module
    load_flax_params(module, ref["flat"])
    with torch.no_grad():
        pred, target, sigmas = spec.forward(
            PortHandle(module, dict(spec.transformer_config)),
            {k: torch.from_numpy(v) for k, v in ref["conditions"].items()},
            {k: torch.from_numpy(v) for k, v in ref["latents"].items()},
            torch.from_numpy(ref["sigmas"]), draws=ref["draws"])
    np.testing.assert_array_equal(sigmas.numpy(), ref["sigmas"])
    np.testing.assert_allclose(target.numpy(), ref["target"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(pred.numpy(), ref["pred"], atol=ATOL, rtol=0)
    assert pred.shape == target.shape == (2, 3, 4, 8, 12)


def test_cogvideox_train_step_matches_jax(monkeypatch):
    jax_embedding(monkeypatch)
    ref = _jax_reference()
    spec = _port_spec()
    trainer = SFTTrainer(BaseArgs(training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0, target_modules=TARGETS,
                                  flow_weighting_scheme="logit_normal", flow_shift=3.0, **_optimizer_args()), spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, ref["flat"])
    assert isinstance(trainer.scheduler, CogVideoXDDIMScheduler)  # no `shift`: flow_shift is not applied
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in ref["conditions"].items()},
                             {k: torch.from_numpy(v) for k, v in ref["latents"].items()}, draws=ref["draws"])
    np.testing.assert_allclose(float(out["loss"]), ref["loss"], atol=ATOL * max(1.0, abs(ref["loss"])), rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), ref["max_loss"], atol=ATOL * max(1.0, ref["max_loss"]),
                               rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), ref["grad_norm"], atol=ATOL * max(1.0, ref["grad_norm"]),
                               rtol=0)
    clip = min(1.0, 1.0 / ref["grad_norm"])
    params = dict(trainer.transformer.module.named_parameters())
    assert sorted(ref["grads"]) == sorted(trainer._trainable) and len(ref["grads"]) == LORA_LAYERS * 2
    assert any(".ff.net.2." in name for name in ref["grads"])  # every LoRA layer trains, as in JAX
    for name in ref["grads"]:
        np.testing.assert_allclose(params[name].grad.numpy(), clip * ref["grads"][name], atol=ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(params[name].detach().numpy(), ref["updated"][name], atol=ATOL, rtol=0,
                                   err_msg=name)
        assert not np.allclose(params[name].detach().numpy(), ref["initial"][name], atol=1e-7, rtol=0), name
    for name, param in params.items():
        if name not in trainer._trainable:
            assert not param.requires_grad and param.grad is None, name
