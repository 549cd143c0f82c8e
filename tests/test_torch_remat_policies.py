"""The selective remat policies `ops`, `ops_attn` and `ops_narrow` on the Wan
LoRA training step, with K4's forward the dispatcher op
`finetrainers_torch::flash_mha`.

- Against JAX: the port's tiny Wan train step (the model of
  `test_torch_wan_train_step.py`: 2 blocks, 2 heads of 64, fp32) under each
  policy matches the JAX train step whose blocks are rematerialized under the
  same `jax.checkpoint` policy: loss, grad norm and every LoRA factor after
  the update at atol 1e-4, with JAX's draws handed over.
- Against itself: under each policy the port's step is bit-equal on the CPU
  to its step under per-block `full` remat (and to the step without remat).
- Dispatch probe: a `TorchDispatchMode` counts the K4 op's forward calls
  through one forward and backward: once per attention call under the
  selective policies (saved, never recomputed), twice under `full`.
- Each policy saves what it says: the products it saves are not recomputed.
- An unknown policy name raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from finetrainers_tpu_torch.models.layers import block_stack
from finetrainers_tpu_torch.models.wan import load_flax_params, wan_key_map
from finetrainers_tpu_torch.models.weight_utils import flax_to_torch_state_dict
from finetrainers_tpu_torch.ops.flash_attention import FlashAttentionFunction
from finetrainers_tpu_torch.trainer import SFTTrainer
from finetrainers_tpu_torch.utils.activation_checkpoint import apply_activation_checkpointing
from test_torch_wan_train_step import ALPHA, MOMENTS, RANK, TINY, _batch, _jax_params, _unflatten

torch.set_num_threads(1)

ATOL = 1e-4
POLICIES = ("ops", "ops_attn", "ops_narrow")
FLASH_OP = torch.ops.finetrainers_torch.flash_mha.default


@functools.lru_cache(maxsize=None)
def _jax_flat():
    return _jax_params(JaxWan(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_step(policy):
    """JAX's train step on the tiny Wan spec with its blocks under `policy`:
    loss, grad norm, the LoRA factors after the update (peft names) and the draws."""
    spec = JaxSpec(transformer_config=TINY, lora_rank=RANK, lora_alpha=ALPHA)
    spec.transformer_dtype = jnp.float32
    module = JaxWan(**TINY, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32, gradient_checkpointing=policy)
    flat = _jax_flat()
    params = _unflatten(flat)
    trainable, frozen = split_params(params, jax_lora_mask(params))
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
            return jnp.mean(w * (pred.astype(jnp.float32) - target.astype(jnp.float32)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(trainable)
        updates, _ = optimizer.update(grads, optimizer.init(trainable), trainable)
        return loss, optax.global_norm(grads), optax.apply_updates(trainable, updates)

    rng = jax.random.PRNGKey(2)
    loss, grad_norm, updated = step(trainable, rng)
    rng_sigmas, rng_fwd = jax.random.split(rng)
    rng_post, rng_noise = jax.random.split(rng_fwd)
    b, c2, f, h, w = MOMENTS
    draws = {
        "sigmas": np.array(jax.random.uniform(rng_sigmas, (batch,), jnp.float32)),
        "posterior": np.array(jax.random.normal(rng_post, (b, c2 // 2, f, h, w), jnp.float32)),
        "noise": np.array(jax.random.normal(rng_noise, (b, c2 // 2, f, h, w), jnp.float32)),
    }
    lora = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(updated)).items()
            if k.endswith(("lora_a", "lora_b"))}
    return flat, conditions, latents, draws, float(loss), float(grad_norm), flax_to_torch_state_dict(lora, wan_key_map)


def _port_step(flat, conditions, latents, draws, policy):
    """The port's trainer under `policy` (None: no remat) after one train step."""
    spec = get_model_specification_cls("wan", "lora")(device="cpu", transformer_config=TINY,
                                                      transformer_dtype=torch.float32)
    args = BaseArgs(training_type="lora", rank=RANK, lora_alpha=ALPHA, seed=0, gradient_checkpointing=policy is not None,
                    gradient_checkpointing_type=policy or "full")
    trainer = SFTTrainer(args, spec)
    trainer.prepare()
    load_flax_params(trainer.transformer.module, flat)
    assert trainer.transformer.module.gradient_checkpointing == policy
    out = trainer.train_step({k: torch.from_numpy(v) for k, v in conditions.items()},
                             {k: torch.from_numpy(v) for k, v in latents.items()}, draws=draws)
    return trainer, out


class _CountOps(TorchDispatchMode):
    """Counts the ops that reach the dispatcher below autograd, by overload."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] = self.calls.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_train_step_matches_jax_and_full(policy):
    flat, conditions, latents, draws, loss, grad_norm, updated = _jax_step(policy)
    trainer, out = _port_step(flat, conditions, latents, draws, policy)
    np.testing.assert_allclose(float(out["loss"]), loss, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(out["grad_norm"]), grad_norm, atol=ATOL, rtol=0)
    params = dict(trainer.transformer.module.named_parameters())
    assert sorted(updated) == sorted(trainer._trainable)
    for name, value in updated.items():
        np.testing.assert_allclose(params[name].detach().numpy(), value, atol=ATOL, rtol=0, err_msg=name)
    # The same step under per-block full remat and without remat: bit-equal on the CPU.
    for other in ("full", None):
        ref_trainer, ref_out = _port_step(flat, conditions, latents, draws, other)
        assert torch.equal(out["loss"], ref_out["loss"]) and torch.equal(out["grad_norm"], ref_out["grad_norm"])
        ref_params = dict(ref_trainer.transformer.module.named_parameters())
        for name in trainer._trainable:
            assert torch.equal(params[name], ref_params[name]), (other, name)
            assert torch.equal(params[name].grad, ref_params[name].grad), (other, name)


@pytest.mark.parametrize("policy,per_call", [("full", 2), ("ops", 1), ("ops_attn", 1), ("ops_narrow", 1),
                                             ("block_skip", 1.5)])
def test_flash_op_forward_runs_once_per_block_under_selective_policies(policy, per_call):
    """Two attention calls per block (self and cross) over the 2 blocks: the
    K4 op's forward runs 4 times in the forward and, under `full`, 4 more in
    the recompute; `block_skip` recomputes only the first block."""
    flat, conditions, latents, draws, *_ = _jax_step("ops")
    with _CountOps() as mode:
        _port_step(flat, conditions, latents, draws, policy)
    assert mode.calls[FLASH_OP] == int(per_call * 2 * TINY["num_layers"])


@pytest.mark.parametrize("policy,recomputed_products,flash_calls",
                         [("full", 2, 2), ("ops", 0, 1), ("ops_attn", 2, 1), ("ops_narrow", 1, 1)])
def test_policy_saves_what_it_names(policy, recomputed_products, flash_calls):
    """A block of a product 4097 wide and a product 16 wide feeding K4,
    counted through one forward and backward: a saved op runs once, a
    recomputed one once more (the recompute runs up to K4's residuals). `ops` saves both products, `ops_narrow` only
    the narrow one, `ops_attn` neither; every selective policy saves K4."""
    g = torch.Generator().manual_seed(0)
    narrow, wide = torch.randn(64, 16, generator=g), torch.randn(64, 4097, generator=g)
    x = torch.randn(8, 64, generator=g, requires_grad=True)

    def block(h):
        y = (h @ wide).sum()
        q = (h @ narrow)[None, None]
        return FlashAttentionFunction.apply(q, q, q, None, None, None, 0.25).sum() + y

    with _CountOps() as mode:
        apply_activation_checkpointing(block, policy)(x).backward()
    # Two products in the forward, one more for each recomputed, and one in the backward for each (dx).
    assert mode.calls[torch.ops.aten.mm.default] == 2 + recomputed_products + 2
    assert mode.calls[FLASH_OP] == flash_calls


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="Unknown checkpoint type"):
        apply_activation_checkpointing(lambda h: h, "ops_everything")
    blocks = torch.nn.ModuleList([torch.nn.Linear(4, 4)])
    with pytest.raises(ValueError, match="Unknown checkpoint type"):
        block_stack(blocks, torch.zeros(2, 4, requires_grad=True), checkpoint="selective")
