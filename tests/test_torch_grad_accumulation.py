"""Gradient accumulation: the port's `MultiSteps` against JAX's
`optax.MultiSteps(get_optimizer(...), 2)`, the wrapper the JAX trainer builds
for `--gradient_accumulation_steps 2` (`trainer/sft_trainer/trainer.py:205-206`).

Both get the same four micro-batches of gradients (seeded numpy, norms of a
few, so the clip at 1.0 acts on the mean) for three fp32 parameters. After
each micro-step, at atol 1e-5: the parameters, the AdamW moments and the
schedule's count (applied updates, not micro-steps; a warm-up schedule, so
the count decides the learning rate). The parameters do not change after
the odd micro-steps, and the norm `step` returns is the micro-batch's, before
any clip.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu_torch.optimizer import MultiSteps, get_lr_scheduler, get_optimizer

torch.set_num_threads(1)

SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 2, 5)}
OPT_KW = dict(beta1=0.9, beta2=0.99, epsilon=1e-8, weight_decay=1e-2, max_grad_norm=1.0)
SCHEDULE = ("constant_with_warmup", 1e-2, dict(warmup_steps=3, train_steps=10))
K = 2
ATOL = 1e-5


def _inputs():
    rng = np.random.RandomState(3)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
             for scale in (0.2, 1.5, 0.7, 0.1)]
    return params, grads


def _adam_states(state):
    return [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]


def _schedule_count(state):
    return [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
            if isinstance(s, optax.ScaleByScheduleState)][0].count


def test_multisteps_matches_optax_multisteps():
    params, grads = _inputs()
    name, lr, kw = SCHEDULE
    jax_opt = optax.MultiSteps(jax_optimizer("adamw", jax_lr_scheduler(name, lr, **kw), **OPT_KW), K)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    jax_state = jax_opt.init(jax_params)

    port_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    port = get_optimizer("adamw", port_params.values(), get_lr_scheduler(name, lr, **kw), **OPT_KW)
    optimizer = MultiSteps(port, K)

    for i, micro in enumerate(grads):
        jax_grads = {k: jnp.asarray(v) for k, v in micro.items()}
        updates, jax_state = jax_opt.update(jax_grads, jax_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)

        before = {k: p.detach().clone() for k, p in port_params.items()}
        optimizer.zero_grad()
        for k, p in port_params.items():
            p.grad = torch.from_numpy(micro[k].copy())
        norm = optimizer.step()

        np.testing.assert_allclose(float(norm), float(optax.global_norm(jax_grads)), atol=ATOL, rtol=0)
        applied = (i + 1) // K
        assert optimizer.count == applied == int(_schedule_count(jax_state))
        assert optimizer.mini_step == int(jax_state.mini_step) == (i + 1) % K
        for k, p in port_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[k]), atol=ATOL, rtol=0, err_msg=k)
            if (i + 1) % K:
                assert torch.equal(p.detach(), before[k]), f"{k} changed on micro-step {i + 1}"
            elif applied > 1:  # the warm-up's first learning rate is 0
                assert not torch.equal(p.detach(), before[k]), f"{k} did not move on micro-step {i + 1}"
        (adam,) = _adam_states(jax_state)
        assert int(adam.count) == applied
        for k, p in port_params.items():
            state = port.inner.state.get(p, {})
            if applied:
                np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(adam.mu[k]), atol=ATOL, rtol=0)
                np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]), atol=ATOL, rtol=0)
                assert int(state["step"]) == applied
            else:
                assert not state


@pytest.mark.parametrize("mini_step", [0, 1])
def test_multisteps_state_round_trip(mini_step):
    """A state dict taken after `mini_step` micro-steps past an update, through
    `torch.save` and `torch.load(weights_only=True)` as a checkpoint takes
    it, loaded into a fresh wrapper, continues bit-equal to the wrapper it
    came from."""
    params, grads = _inputs()
    name, lr, kw = SCHEDULE

    def build():
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
        return ps, MultiSteps(get_optimizer("adamw", ps, get_lr_scheduler(name, lr, **kw), **OPT_KW), K)

    def micro_step(ps, opt, micro):
        opt.zero_grad()
        for p, g in zip(ps, micro.values()):
            p.grad = torch.from_numpy(g.copy())
        opt.step()

    ps, opt = build()
    for micro in grads[:K + mini_step]:
        micro_step(ps, opt, micro)
    fresh_ps, fresh = build()
    with torch.no_grad():
        for p, q in zip(fresh_ps, ps):
            p.copy_(q)
    buffer = io.BytesIO()
    torch.save(opt.state_dict(), buffer)
    buffer.seek(0)
    fresh.load_state_dict(torch.load(buffer, weights_only=True))
    assert fresh.mini_step == mini_step and fresh.count == 1
    for micro in grads[K + mini_step:]:
        micro_step(ps, opt, micro)
        micro_step(fresh_ps, fresh, micro)
    for p, q in zip(ps, fresh_ps):
        assert torch.equal(p, q)
