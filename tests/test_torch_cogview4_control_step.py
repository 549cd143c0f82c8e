"""The CogView4 control-LoRA training slice: one `ControlTrainer.train_step` of
the port against JAX's `value_and_grad` of the same loss through
`CogView4ControlModelSpecification.forward`, the control exports
(`control_aux_weights.safetensors` written by each package and read by the
other), and the quirks ROADMAP.md section 3 records.

Both sides run the tiny CogView4 model in fp32 (2 blocks, 2 heads of 64)
widened to 8 input channels (2x the 4 latent channels), LoRA rank 4, with
JAX's weights through `load_flax_params` (nonzero `lora_b`, noise on every
bias and norm scale). The batch: seeded image moments (2, 8, 8, 12) and
control moments of the same shape, 8 text slots, sizes and crops. The JAX
step: logit-normal sigmas from `FlowMatchEulerScheduler()`, the control
spec's forward (posterior sample and noise from `split(rng, 3)`, the control
latents' posterior mean joined on the channel axis), the logit-normal loss
weighting, optax AdamW with the trainer's defaults. Its draws are handed to
the port, and its sinusoidal embeddings too (one fp32 `exp` ulp apart; held
on their own in test_torch_cogview4_transformer.py). Trained, as in JAX's
control trainer: every LoRA factor and, at full rank, the injection layer
`patch_embed_proj`. Compared at atol 1e-4: loss, max loss, grad norm, every
trained gradient (clipped in place) and value after the update.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors.numpy import load_file as np_load_file

from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import apply_auxiliary_weights as jax_apply_auxiliary_weights
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.lora import trainable_mask as jax_trainable_mask
from finetrainers_tpu.models.cogview4 import CogView4ControlModelSpecification as JaxControlSpec
from finetrainers_tpu.models.cogview4 import CogView4Transformer2DModel as JaxCogView4
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu.trainer.control_trainer import ControlTrainer as JaxControlTrainer
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, apply_auxiliary_weights, load_lora_weights
from finetrainers_tpu_torch.models.cogview4 import cogview4_key_map, load_flax_params
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.trainer.control_trainer import (
    AUX_WEIGHTS_NAME,
    ControlTrainer,
    save_control_aux_weights,
)
from test_torch_cogview4_transformer import TINY, jax_embedding, jax_params, unflatten

torch.set_num_threads(1)

RANK, ALPHA = 4, 8.0
MOMENTS = (2, 8, 8, 12)  # (B, 2C, H, W)
TEXT_LEN = 8
ATOL = 1e-4
WIDE = dict(TINY, in_channels=8)


def _batch():
    rng = np.random.RandomState(11)
    b, c2 = MOMENTS[:2]
    latents = {}
    for name in ("latents", "control_latents"):
        moments = rng.randn(*MOMENTS).astype(np.float32)
        moments[:, c2 // 2:] = -1.0 + 0.5 * moments[:, c2 // 2:]  # log-variance
        latents[name] = moments
    latents.update(original_size=np.asarray([[16, 24], [32, 48]], np.float32),
                   target_size=np.asarray([[16, 24], [16, 24]], np.float32),
                   crop_coords=np.asarray([[0, 0], [4, 2]], np.float32))
    conditions = {"encoder_hidden_states": rng.randn(b, TEXT_LEN, 32).astype(np.float32)}
    return conditions, latents


def _trained(tree):
    """A flax tree's trained leaves (LoRA and the injection layer) by port name and layout."""
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if k.endswith(("lora_a", "lora_b")) or k.startswith("patch_embed_proj.")}
    return flax_to_torch_state_dict(flat, cogview4_key_map)


def _is_trained(path):
    return "lora_a" in path or "lora_b" in path or "patch_embed_proj" in path


@functools.lru_cache(maxsize=None)
def _jax_reference():
    spec = JaxControlSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    module = JaxCogView4(**WIDE, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32, use_scan=False)
    flat = jax_params(module, cfg=WIDE)
    params = unflatten(flat)
    trainable, frozen = split_params(params, jax_trainable_mask(params, _is_trained))
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
        sigmas = scheduler.training_sigmas(rng_sigmas, batch, flow_weighting_scheme="logit_normal")

        def loss_fn(trainable):
            handle = ModelHandle(module, merge_params(trainable, frozen), WIDE)
            pred, target, sigmas_out = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            w = jax_loss_weighting("logit_normal", sigmas=sigmas_out).reshape(-1, 1, 1, 1)
            per_sample = w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2
            return jnp.mean(per_sample), jnp.max(jnp.mean(per_sample, axis=(1, 2, 3)))

        (loss, max_loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, max_loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(2)
    loss, max_loss, grad_norm, grads, updated = step(trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise, _ = jax.random.split(rng_fwd, 3)
    b, c2, h, w = MOMENTS
    draws = {
        "sigmas": np.array(jax.random.normal(rng_sigmas, (batch,), jnp.float32)),
        "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, 1, h, w), jnp.float32)),
        "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, h, w), jnp.float32)),
    }
    return (flat, conditions, latents, draws, float(loss), float(max_loss), float(grad_norm), _trained(grads),
            _trained(updated), _trained(params))


def port_trainer(tmp_path=None, **args):
    spec = get_model_specification_cls("cogview4", "control-lora")(device="cpu", transformer_config=TINY,
                                                                   transformer_dtype=torch.float32)
    extra = {} if tmp_path is None else {"output_dir": str(tmp_path)}
    trainer = ControlTrainer(BaseArgs(training_type="control-lora", rank=RANK, lora_alpha=ALPHA, seed=0,
                                      flow_weighting_scheme="logit_normal", **extra, **args), spec)
    trainer.prepare()
    return trainer


def test_control_lora_train_step_matches_jax(monkeypatch):
    jax_embedding(monkeypatch)
    flat, conditions, latents, draws, loss, max_loss, grad_norm, grads, updated, initial = _jax_reference()
    trainer = port_trainer()
    module = trainer.transformer.module
    assert trainer.transformer.config["in_channels"] == 8 and module.patch_embed.proj.in_features == 32
    assert trainer.model_specification.transformer_config["in_channels"] == 4  # the base count stays
    load_flax_params(module, flat)
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    np.testing.assert_allclose(float(out["loss"]), loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["max_loss"]), max_loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), grad_norm, atol=ATOL, rtol=0)
    clip = min(1.0, 1.0 / grad_norm)
    params = dict(module.named_parameters())
    # 2 blocks x 6 LoRA layers (q, k, v, out, 2 feed-forward), each A and B, and the injection layer's 2.
    assert sorted(grads) == sorted(trainer._trainable) and len(grads) == 2 * 6 * 2 + 2
    assert {"patch_embed.proj.weight", "patch_embed.proj.bias"} <= set(grads)
    for name in grads:
        np.testing.assert_allclose(params[name].grad.numpy(), clip * grads[name], atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(params[name].detach().numpy(), updated[name], atol=ATOL, rtol=0, err_msg=name)
        assert not np.allclose(params[name].detach().numpy(), initial[name], atol=1e-7, rtol=0), name
    for name, param in params.items():
        if name not in trainer._trainable:
            assert not param.requires_grad and param.grad is None, name


def test_qk_norms_train_under_train_qk_norm():
    trainer = port_trainer(train_qk_norm=True)
    trained = sorted(n for n in trainer._trainable if ".lora_" not in n)
    assert trained == sorted(["patch_embed.proj.weight", "patch_embed.proj.bias"]
                             + [f"transformer_blocks.{i}.attn1.norm_{x}.{p}" for i in range(2) for x in "qk"
                                for p in ("weight", "bias")])


def test_full_width_trained_parameter_count():
    """The canny example at full width: 6,631,406,656 parameters, 264,769,536
    trained (LoRA rank 128 and the injection layer), built on the meta device."""
    spec = get_model_specification_cls("cogview4", "control-lora")(device="meta")
    trainer = ControlTrainer.__new__(ControlTrainer)
    trainer.args = BaseArgs(training_type="control-lora", rank=128, lora_alpha=128)
    trainer.model_specification = spec
    trainer.state = types.SimpleNamespace()
    spec.generator = lambda: None  # meta tensors: the init draws nothing
    trainer._prepare_models()
    trainer._prepare_trainable_parameters()
    module = trainer.transformer.module
    assert sum(p.numel() for p in module.parameters()) == 6_631_406_656
    assert trainer.state.num_trainable_parameters == 264_769_536
    assert module.patch_embed.proj.weight.dtype == torch.float32  # fp32 master of the injection layer
    assert module.transformer_blocks[0].attn1.to_q.weight.dtype == torch.bfloat16


def test_reload_widens_from_the_base_count_where_jax_widens_twice():
    """ROADMAP.md section 3: JAX's control spec writes the widened count back
    into its config, so its trainer's reload for the final validation widens
    the widened count again (16 -> 32 -> 64 at full width, 4 -> 8 -> 16 here);
    the port widens from the base count both times."""
    jax_spec = JaxControlSpec(transformer_config=TINY)
    jax_spec.load_diffusion_models = types.MethodType(
        lambda self, new_in_features=None: self.transformer_config.update(in_channels=new_in_features)
        or {"transformer": ModelHandle(None, None, dict(self.transformer_config))}, jax_spec)
    jax_trainer = types.SimpleNamespace(model_specification=jax_spec,
                                        args=types.SimpleNamespace(frame_conditioning_concatenate_mask=False))
    first = jax_spec.load_diffusion_models(new_in_features=2 * jax_spec.transformer_config["in_channels"])
    reload = JaxControlTrainer._load_fresh_transformer(jax_trainer)
    assert (first["transformer"].config["in_channels"], reload.config["in_channels"]) == (8, 16)
    trainer = port_trainer()
    fresh = trainer._load_diffusion_models()["transformer"]  # what `_load_exported_transformer` loads
    assert (trainer.transformer.config["in_channels"], fresh.config["in_channels"]) == (8, 8)
    assert fresh.module.patch_embed.proj.in_features == trainer.transformer.module.patch_embed.proj.in_features


@pytest.mark.parametrize("num_layers", [2, 9], ids=["per_block", "scan_stacked"])
def test_aux_weights_each_package_reads_the_others(num_layers, tmp_path):
    """`control_aux_weights.safetensors` with the injection layer and the qk
    norms (`--train_qk_norm`): the port writes JAX's flat flax names and (in,
    out) kernels, stacked as `transformer_blocks_scan.block.*` where the JAX
    model scans its blocks (over 8); JAX's `apply_auxiliary_weights` takes it.
    The port reads JAX's file into a fresh model."""
    cfg = dict(TINY, num_layers=num_layers)
    spec = get_model_specification_cls("cogview4", "control-lora")(device="cpu", transformer_config=cfg,
                                                                   transformer_dtype=torch.float32)
    module = spec.load_diffusion_models(new_in_features=8)["transformer"].module
    rng = torch.Generator().manual_seed(4)
    trained = {name: torch.randn(p.shape, generator=rng) for name, p in module.named_parameters()
               if name.startswith("patch_embed.proj.") or ".norm_q." in name or ".norm_k." in name}
    save_control_aux_weights(str(tmp_path / "port"), spec, trained)
    written = np_load_file(str(tmp_path / "port" / AUX_WEIGHTS_NAME))
    if num_layers > 8:
        assert written["transformer_blocks_scan.block.attn1_norm_q.scale"].shape == (9, 64)
    else:
        assert "transformer_blocks_1.attn1_norm_k.bias" in written
    np.testing.assert_array_equal(written["patch_embed_proj.kernel"], trained["patch_embed.proj.weight"].numpy().T)
    jax_module = JaxCogView4(**dict(cfg, in_channels=8), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 4, 4)),
                                                    jnp.zeros((1, 8, 32)), jnp.zeros((1,)))["params"])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    loaded = flatten_params(jax_apply_auxiliary_weights(zeros, str(tmp_path / "port" / AUX_WEIGHTS_NAME)))
    for key, value in written.items():
        np.testing.assert_array_equal(np.asarray(loaded[key]), value, err_msg=key)
    # JAX's writer on the same values (its flat names), read by the port.
    JaxControlTrainer._save_auxiliary_weights(types.SimpleNamespace(model_specification=None), str(tmp_path / "jax"),
                                              {"trainable": unflatten(written)})
    fresh = spec.load_diffusion_models(new_in_features=8)["transformer"].module
    apply_auxiliary_weights(fresh, str(tmp_path / "jax" / AUX_WEIGHTS_NAME), key_map=spec.transformer_key_map)
    params = dict(fresh.named_parameters())
    for name, value in trained.items():
        assert torch.equal(params[name].detach(), value), name


def test_export_writes_adapter_and_aux_and_the_reload_is_bit_equal(tmp_path):
    """A save under control-lora: the adapter holds only the LoRA factors, the
    aux file the injection layer; the final validation's reload (a fresh
    widened model with both applied) computes what the trained model does, bit
    for bit."""
    trainer = port_trainer(tmp_path, checkpointing_steps=1, train_steps=1)
    conditions, latents = _batch()
    batch = ({k: torch.from_numpy(v) for k, v in conditions.items()},
             {k: torch.from_numpy(v) for k, v in latents.items()})
    trainer.train([batch])
    export = tmp_path / "lora_weights" / "000001"
    state, config = load_lora_weights(str(export / LORA_WEIGHTS_NAME))
    assert config["r"] == RANK and all(".lora_" in k for k in state) and len(state) == 2 * 6 * 2
    aux = np_load_file(str(export / AUX_WEIGHTS_NAME))
    assert sorted(aux) == ["patch_embed_proj.bias", "patch_embed_proj.kernel"]
    module = trainer.transformer.module
    np.testing.assert_array_equal(aux["patch_embed_proj.kernel"], module.patch_embed.proj.weight.detach().numpy().T)
    fresh = trainer._load_exported_transformer()
    x = torch.randn(1, 8, 8, 12, generator=torch.Generator().manual_seed(1))
    text = torch.from_numpy(conditions["encoder_hidden_states"][:1])
    with torch.no_grad():
        assert torch.equal(fresh.module(x, text, torch.tensor([500.0])), module(x, text, torch.tensor([500.0])))
