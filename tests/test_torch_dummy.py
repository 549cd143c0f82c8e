"""The dummy family against the JAX package: the hash embedding, the
transformer, the VAE, one LoRA train step and the pipeline.

Both sides run the family at its own width (dim 64 in 2 heads of 32, 2
blocks, 16 caption slots) in fp32 on JAX's weights through
`load_flax_params` (nonzero `lora_b`, biases moved off zero). The sinusoidal
time embedding takes JAX's values (the packages' fp32 `exp` differ by an
ulp, test_torch_flux_transformer.py). The latents are (2, 4, 3, 8, 12): 3 x
4 x 6 = 72 tokens a sample. The JAX step is the trainer's: uniform sigma draw
(weighting "none"), `DummyModelSpecification.forward` (posterior and noise
from its key split), the mean squared flow-matching error, optax AdamW
(clip 1.0, constant rate), compiled at XLA's lowest level (`jax_compiled`);
its draws are rebuilt with the same keys and handed to the port. Compared at atol 1e-4 (the model and VAE outputs, the loss, the
gradients and the updated factors) and exactly for the hash embedding and
the pipeline's uint8 video except where a value sits on a rounding boundary
(at most one level, in at most 0.1% of the pixels).

At head dim 32 the dummy runs the kernels' plain versions wherever JAX runs
its Pallas kernels (interpret mode): the LoRA step again under the `flash`
provider with FINETRAINERS_FLASH_FUSED_BWD=1 and FINETRAINERS_FLASH_TWOLEVEL=1
(JAX's two-level forward and fused backward; the port's K7c and K5 plain
versions), at the same atol 1e-4, and a denoise step (one transformer forward)
under `sage` (JAX's int8 kernel; the port's sage pre-pass and K6 plain
versions) at atol 1e-3: q codes are equal, but smooth-K's mean is summed in
another order, so a k code may differ by one (as the pre-pass tests allow),
and one does, moving the output by ~3e-4.
"""

import contextlib
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax_compiled import compiled

from finetrainers_tpu.functional.diffusion import compute_loss_weighting as jax_loss_weighting
from finetrainers_tpu.lora import lora_mask as jax_lora_mask
from finetrainers_tpu.lora import merge_params, split_params
from finetrainers_tpu.models.dummy.base_specification import DummyModelSpecification as JaxSpec
from finetrainers_tpu.models.dummy.base_specification import DummyTransformer as JaxDummy
from finetrainers_tpu.models.dummy.base_specification import DummyVAE as JaxVAE
from finetrainers_tpu.models.dummy.base_specification import _hash_embedding as jax_hash_embedding
from finetrainers_tpu.models.dummy.pipeline import DummyPipeline as JaxPipeline
from finetrainers_tpu.models.layers import sinusoidal_timestep_embedding as jax_timestep_embedding
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.ops import attention_provider as jax_attention_provider
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxEuler
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models import layers as port_layers
from finetrainers_tpu_torch.models.dummy import DummyModelSpecification, DummyVAE, dummy_key_map, load_flax_params
from finetrainers_tpu_torch.models.dummy.base_specification import _hash_embedding
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle as PortHandle
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.ops import attention_provider
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)
port_fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")
port_sage = importlib.import_module("finetrainers_tpu_torch.ops.sage_attention")

RANK, ALPHA = 4, 8.0
# The kernel switches of the switched step, and the plain versions the port's CPU calls take under them.
SWITCHES = {"FINETRAINERS_FLASH_FUSED_BWD": "flash_backward_fused_reference",
            "FINETRAINERS_FLASH_TWOLEVEL": "flash_forward_two_level_reference"}
LATENTS = (2, 4, 3, 8, 12)  # (B, C, F, H, W)
ATOL = 1e-4  # fp32 products summed in another order than XLA sums them
# Under `sage`: smooth-K's mean is summed in another order, so a k code may differ by one (as the pre-pass
# tests allow); here one does, and moves the output by ~3e-4.
SAGE_ATOL = 1e-3


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def jax_embedding(monkeypatch):
    """Give the port's layers JAX's sinusoidal embedding of the same timesteps."""
    monkeypatch.setattr(port_layers, "sinusoidal_timestep_embedding", lambda t, dim, **kw: torch.from_numpy(
        np.array(jax_timestep_embedding(jnp.asarray(t.cpu().numpy()), dim, **kw))).to(t.device))


def _moved(flat, seed):
    rng = np.random.RandomState(seed)
    for key in flat:
        if key.endswith("lora_b"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith("bias"):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return flat


def _inputs():
    rng = np.random.RandomState(3)
    b = LATENTS[0]
    x = rng.randn(*LATENTS).astype(np.float32)
    ehs = np.concatenate([_hash_embedding(c, 16, 32)[None] for c in ("a fox", "waves")])
    return x, ehs, np.asarray([700.0, 12.5], np.float32)[:b], np.asarray([16, 5], np.int32)[:b]


@functools.lru_cache(maxsize=None)
def jax_model(lora_rank):
    """JAX's weights (flattened, moved off their init) and its output on `_inputs`."""
    module = JaxDummy(lora_rank=lora_rank, lora_alpha=ALPHA, dtype=jnp.float32)
    x, ehs, t, lens = map(jnp.asarray, _inputs())
    params = drawn_params(module, x, ehs, t)
    flat = _moved({k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}, 7)
    out = jax.jit(lambda p: module.apply({"params": p}, x, ehs, t, encoder_kv_lens=lens))(unflatten(flat))
    return flat, np.asarray(out)


def port_model(flat, lora_rank):
    spec = DummyModelSpecification(device="cpu", transformer_dtype=torch.float32, lora_rank=lora_rank,
                                   lora_alpha=ALPHA)
    return load_flax_params(spec.load_diffusion_models()["transformer"].module, flat)


def test_hash_embedding_bit_equal():
    for text in ("", "a red fox", "PIKA_CRUSH a press"):
        np.testing.assert_array_equal(_hash_embedding(text, 16, 32), jax_hash_embedding(text, 16, 32))
    spec = DummyModelSpecification(device="cpu")
    conds = spec.prepare_conditions(caption="a fox")
    ref = JaxSpec().prepare_conditions(caption="a fox")
    for key in ("encoder_hidden_states", "encoder_kv_lens"):
        np.testing.assert_array_equal(conds[key], ref[key])


@pytest.mark.parametrize("lora_rank", [0, RANK], ids=["base", "lora"])
def test_transformer_matches_jax(lora_rank, monkeypatch):
    """The transformer (self-attention over 72 tokens, cross-attention over the
    16 caption slots with kv_lens [16, 5]) on JAX's weights, at head dim 32."""
    jax_embedding(monkeypatch)
    flat, ref = jax_model(lora_rank)
    model = port_model(flat, lora_rank)
    assert model.blocks[0].attn1.head_dim == 32 and len(model.blocks) == 2
    with torch.no_grad():
        x, ehs, t, lens = map(torch.from_numpy, _inputs())
        out = model(x, ehs, t, encoder_kv_lens=lens)
    assert out.dtype == torch.float32 and out.shape == LATENTS
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_vae_matches_jax():
    module = JaxVAE()
    x = np.random.RandomState(4).uniform(-1, 1, (1, 3, 2, 16, 24)).astype(np.float32)
    params = drawn_params(module, jnp.zeros((1, 3, 1, 8, 8)))
    flat = _moved({k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}, 9)
    moments = np.asarray(module.apply({"params": unflatten(flat)}, jnp.asarray(x), method=JaxVAE.encode))
    decoded = np.asarray(module.apply({"params": unflatten(flat)}, jnp.asarray(moments[:, :4]), method=JaxVAE.decode))
    vae = load_flax_params(DummyVAE(), flat)
    with torch.no_grad():
        got = vae.encode(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), moments, atol=ATOL, rtol=0)
        np.testing.assert_allclose(vae.decode(torch.from_numpy(moments[:, :4])).numpy(), decoded, atol=ATOL, rtol=0)
    assert got.shape == (1, 8, 2, 2, 3)


def _optimizer_args():
    return dict(optimizer="adamw", lr=1e-3, lr_scheduler="constant", beta1=0.9, beta2=0.95, weight_decay=1e-4,
                epsilon=1e-8, max_grad_norm=1.0)


def _batch():
    rng = np.random.RandomState(11)
    moments = rng.randn(LATENTS[0], 2 * LATENTS[1], *LATENTS[2:]).astype(np.float32)
    moments[:, LATENTS[1]:] = -1.0 + 0.5 * moments[:, LATENTS[1]:]  # log-variance
    _, ehs, _, lens = _inputs()
    return {"encoder_hidden_states": ehs, "encoder_kv_lens": lens}, {"latents": moments}


def _lora_state(tree):
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return flax_to_torch_state_dict(flat, dummy_key_map)


@contextlib.contextmanager
def _switches(names):
    """The JAX package's kernel switches set while it traces (a cached step outlives a test's monkeypatch)."""
    old = {name: os.environ.get(name) for name in names}
    os.environ.update(dict.fromkeys(names, "1"))
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value


@functools.lru_cache(maxsize=None)
def _jax_step(provider=None, switches=()):
    """JAX's LoRA train step (under attention `provider` and the kernel
    `switches` where given): loss, grad norm, gradients, updated factors, draws."""
    spec = JaxSpec(lora_rank=RANK, lora_alpha=ALPHA)
    module = JaxDummy(lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32)
    flat, _ = jax_model(RANK)
    params = unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
    conditions, latents = _batch()
    conds = {k: jnp.asarray(v) for k, v in conditions.items()}
    lats = {k: jnp.asarray(v) for k, v in latents.items()}
    scheduler = JaxEuler()
    opt = _optimizer_args()
    optimizer = jax_optimizer("adamw", jax_lr_scheduler("constant", opt["lr"]), beta1=0.9, beta2=0.95, epsilon=1e-8,
                              weight_decay=1e-4, max_grad_norm=1.0)

    def step(trainable, rng):
        rng_sigmas, rng_fwd = jax.random.split(rng)
        sigmas = scheduler.training_sigmas(rng_sigmas, LATENTS[0], flow_weighting_scheme="none")

        def loss_fn(trainable):
            handle = ModelHandle(module, merge_params(trainable, frozen), dict(spec.transformer_config))
            pred, target, sigmas_out = spec.forward(handle, conds, lats, sigmas, rng_fwd)
            w = jax_loss_weighting("none", sigmas=sigmas_out).reshape(-1, 1, 1, 1, 1)
            return jnp.mean(w * (pred - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, optax.global_norm(grads), grads, optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(2)
    with _switches(switches), jax_attention_provider(provider) if provider else contextlib.nullcontext():
        loss, grad_norm, grads, updated = compiled(step, trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    shape = LATENTS
    draws = {"sigmas": np.array(jax.random.uniform(rng_sigmas, (LATENTS[0],), dtype=jnp.float32)),
             "posterior": np.array(jax.random.normal(rng_post, shape)),
             "noise": np.array(jax.random.normal(rng_noise, shape, jnp.float32))}
    return dict(flat=flat, conditions=conditions, latents=latents, draws=draws, loss=float(loss),
                grad_norm=float(grad_norm), grads=_lora_state(grads), updated=_lora_state(updated))


def _check_lora_train_step(ref, provider=None):
    """The port's LoRA step on JAX's weights, draws and batch (under attention
    `provider` where given) against JAX's `ref` (`_jax_step`)."""
    spec = get_model_specification_cls("dummy", "lora")(device="cpu", transformer_dtype=torch.float32)
    trainer = SFTTrainer(BaseArgs(model_name="dummy", training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0,
                                  flow_weighting_scheme="none", **_optimizer_args()), spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, ref["flat"])
    with attention_provider(provider) if provider else contextlib.nullcontext():
        out = trainer.train_step({k: torch.from_numpy(v) for k, v in ref["conditions"].items()},
                                 {k: torch.from_numpy(v) for k, v in ref["latents"].items()}, draws=ref["draws"])
    np.testing.assert_allclose(float(out["loss"]), ref["loss"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), ref["grad_norm"], atol=ATOL * max(1.0, ref["grad_norm"]),
                               rtol=0)
    clip = min(1.0, 1.0 / ref["grad_norm"])
    params = dict(trainer.transformer.module.named_parameters())
    # q, k, v, out of both attentions and the MLP's two layers, in each of the 2 blocks
    assert sorted(ref["grads"]) == sorted(trainer._trainable) and len(ref["grads"]) == 2 * 10 * 2
    for name in ref["grads"]:
        np.testing.assert_allclose(params[name].grad.numpy(), clip * ref["grads"][name], atol=ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(params[name].detach().numpy(), ref["updated"][name], atol=ATOL, rtol=0,
                                   err_msg=name)


def test_lora_train_step_matches_jax(monkeypatch):
    jax_embedding(monkeypatch)
    _check_lora_train_step(_jax_step())


def test_lora_train_step_under_fused_backward_and_two_level_switches_matches_jax(monkeypatch):
    """The LoRA step under `flash` with the fused-backward and two-level
    switches: JAX's Pallas two-level forward and fused backward against the
    port's K7c and K5 plain versions, each called for every attention (self
    and cross, in each of the 2 blocks)."""
    jax_embedding(monkeypatch)
    ref = _jax_step("flash", tuple(SWITCHES))
    calls = {}
    for switch, plain in SWITCHES.items():
        monkeypatch.setenv(switch, "1")
        fn = getattr(port_fa, plain)
        calls[plain] = []
        monkeypatch.setattr(port_fa, plain, functools.partial(
            lambda fn, seen, *a, **kw: seen.append(1) or fn(*a, **kw), fn, calls[plain]))
    _check_lora_train_step(ref, "flash")
    assert {name: len(seen) for name, seen in calls.items()} == dict.fromkeys(SWITCHES.values(), 2 * 2)


def test_sage_denoise_step_matches_jax(monkeypatch):
    """One denoise step (the transformer at timesteps 700 and 12.5, base
    weights) under `sage` on both sides: JAX's Pallas int8 kernel against the
    port's sage pre-pass and K6 plain versions, K6's called for every
    attention."""
    jax_embedding(monkeypatch)
    flat, _ = jax_model(0)
    module = JaxDummy(dtype=jnp.float32)
    x, ehs, t, lens = _inputs()
    apply = jax.jit(lambda p, x, ehs, t, lens: module.apply({"params": p}, x, ehs, t, encoder_kv_lens=lens))
    with jax_attention_provider("sage"):
        ref = np.asarray(apply(unflatten(flat), *map(jnp.asarray, (x, ehs, t, lens))))
    model = port_model(flat, 0)
    calls, plain = [], port_sage.sage_attention_reference
    monkeypatch.setattr(port_sage, "sage_attention_reference", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    with torch.no_grad(), attention_provider("sage"):
        out = model(*map(torch.from_numpy, (x, ehs, t, lens)))
    assert len(calls) == 2 * 2 and out.shape == LATENTS
    np.testing.assert_allclose(out.numpy(), ref, atol=SAGE_ATOL, rtol=0)


def test_pipeline_matches_jax(monkeypatch):
    """Four Euler steps at 2x32x48 and the VAE decode, from JAX's initial draw:
    the uint8 video equal to JAX's but for values on a rounding boundary."""
    jax_embedding(monkeypatch)
    flat, _ = jax_model(0)
    jax_spec = JaxSpec()
    jax_spec.transformer_dtype = jnp.float32
    module = JaxDummy(dtype=jnp.float32)
    vae_module = JaxVAE()
    vae_params = drawn_params(vae_module, jnp.zeros((1, 3, 1, 8, 8)))
    vae_flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(vae_params)).items()}
    request = dict(prompt="a fox", height=32, width=48, num_frames=2, num_inference_steps=4, seed=5)
    ref = JaxPipeline(spec=jax_spec, transformer=ModelHandle(module, unflatten(flat), {}),
                      vae=ModelHandle(vae_module, unflatten(vae_flat), dict(jax_spec.vae_config)),
                      scheduler=JaxEuler())(**request)
    draw = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 4, 2, 4, 6), dtype=jnp.float32))
    spec = DummyModelSpecification(device="cpu", transformer_dtype=torch.float32)
    transformer = PortHandle(port_model(flat, 0), {})
    vae = PortHandle(load_flax_params(DummyVAE(), vae_flat), dict(spec.vae_config))
    got = spec.load_pipeline(transformer=transformer, vae=vae)(**request, latents=torch.from_numpy(draw))
    assert got.shape == ref.shape == (2, 32, 48, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
