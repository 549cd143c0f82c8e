"""Optimizer parity: the port's schedules and clipped adam/adamw against the JAX
package's optax chains (`finetrainers_tpu/optimizer.py`).

Schedules: every step of a run with warmup, compared at rtol 1e-5 and atol
1e-6 of the peak rate (the JAX schedules evaluate in fp32, the port in fp64;
near a zero of the cosine fp32 keeps fewer relative digits). Optimizers: four updates of three
parameter arrays with numpy gradients whose global norm is above the clip
bound on some steps and below it on others, under a warmup schedule, compared
at atol 1e-6 on the parameters and rtol 1e-5 on the pre-clip global norm.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu_torch.optimizer import SUPPORTED_SCHEDULERS, get_lr_scheduler, get_optimizer

torch.set_num_threads(1)

SCHEDULE_KW = dict(warmup_steps=3, train_steps=10, num_cycles=2, power=2.0)


@pytest.mark.parametrize("name", SUPPORTED_SCHEDULERS)
def test_schedule_matches_optax(name):
    kw = dict(SCHEDULE_KW, step_rules="1:4,0.1:7,0.01" if name == "piecewise_constant" else None)
    lr = 2e-3
    ref, port = jax_lr_scheduler(name, lr, **kw), get_lr_scheduler(name, lr, **kw)
    for step in range(13):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-5, atol=1e-6 * lr, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_clipped_optimizer_matches_optax(name):
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * scale).astype(np.float32) for s in shapes] for scale in (2.0, 0.05, 1.5, 0.1)]
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=1e-2, max_grad_norm=1.0)

    ref_opt = jax_optimizer(name, jax_lr_scheduler("constant_with_warmup", 1e-2, warmup_steps=2), **kw)
    ref_params = [jnp.asarray(x) for x in init]
    state = ref_opt.init(ref_params)
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = get_optimizer(name, params, get_lr_scheduler("constant_with_warmup", 1e-2, warmup_steps=2), **kw)
    for step_grads in grads:
        ref_norm = float(optax.global_norm([jnp.asarray(g) for g in step_grads]))
        updates, state = ref_opt.update([jnp.asarray(g) for g in step_grads], state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        opt.zero_grad()
        for p, g in zip(params, step_grads):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-5)
        for p, ref in zip(params, ref_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    assert opt.count == len(grads)


