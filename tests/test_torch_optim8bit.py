"""The 8-bit optimizers against the JAX package: three steps of
`adamw-bnb-8bit` (and one of `adam-bnb-8bit`) with the clip, on a dense
kernel big enough for int8 moments (64 x 256 = 16,384 elements, the dummy
family's feed-forward kernel), a LoRA factor and a bias under the 4096-element
threshold (fp32 moments).

After each step the int8 codes of both moments equal JAX's at the transposed
position (the port's kernel is JAX's (in, out) transposed, quantized over its
first dim), the scales match within rtol 1e-6 and the fp32 moments within
1e-6 of their largest value (the clip rounds t / n * c where the port rounds
t * (c / n), and a moment that cancels to near 0 keeps that ulp); the
parameters agree within 1e-7 (absolute): a learning rate of
1e-3 times the update, computed in the same fp32 order. The threshold is
read from FINETRAINERS_8BIT_MIN_SIZE, as JAX reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.optim8bit import ScaleByAdam8bitState, _Quantized
from finetrainers_tpu.optimizer import get_lr_scheduler as jax_lr_scheduler
from finetrainers_tpu.optimizer import get_optimizer as jax_optimizer
from finetrainers_tpu_torch.optim8bit import Adam8bit, jax_row_dims
from finetrainers_tpu_torch.optimizer import get_optimizer

torch.set_num_threads(1)

SHAPES = {"kernel": (64, 256), "lora_a": (64, 8), "bias": (256,)}  # JAX layouts


def _find_state(state):
    if isinstance(state, ScaleByAdam8bitState):
        return state
    if isinstance(state, tuple):
        for child in state:
            found = _find_state(child)
            if found is not None:
                return found
    return None


def _port(value, name):
    return value.T if name != "bias" else value


def _run(name, steps, monkeypatch):
    monkeypatch.delenv("FINETRAINERS_8BIT_MIN_SIZE", raising=False)
    rng = np.random.RandomState(0)
    params = {k: (rng.randn(*s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * rng.uniform(0.01, 1.0, s[-1:])).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    ref_opt = jax_optimizer(name, jax_lr_scheduler("constant", 1e-3), beta1=0.9, beta2=0.99, epsilon=1e-8,
                            weight_decay=1e-2, max_grad_norm=1.0)
    ref_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = ref_opt.init(ref_params)
    port = {k: torch.nn.Parameter(torch.from_numpy(_port(v, k).copy())) for k, v in params.items()}
    opt = get_optimizer(name, list(port.values()), 1e-3, beta1=0.9, beta2=0.99, epsilon=1e-8, weight_decay=1e-2,
                        max_grad_norm=1.0, quant_dims=[0, 0, -1])
    assert isinstance(opt.inner, Adam8bit)
    for g in grads:
        updates, state = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, ref_params)
        ref_params = jax.tree_util.tree_map(lambda p, u: p + u, ref_params, updates)
        opt.zero_grad()
        for k, p in port.items():
            p.grad = torch.from_numpy(_port(g[k], k).copy())
        opt.step()
        adam = _find_state(state)
        for k, p in port.items():
            st = opt.inner.state[p]
            for moment in ("mu", "nu"):
                ref = getattr(adam, moment)[k]
                if isinstance(ref, _Quantized):
                    assert k == "kernel" and f"{moment}_codes" in st
                    np.testing.assert_array_equal(_port(st[f"{moment}_codes"].numpy(), k), np.asarray(ref.codes))
                    np.testing.assert_allclose(_port(st[f"{moment}_scales"].numpy(), k), np.asarray(ref.scales),
                                               rtol=1e-6, atol=0)
                else:
                    assert k != "kernel" and moment in st
                    ref = np.asarray(ref)
                    np.testing.assert_allclose(_port(st[moment].numpy(), k), ref, rtol=0,
                                               atol=1e-6 * np.abs(ref).max(), err_msg=f"{k} {moment} step {opt.count}")
            np.testing.assert_allclose(_port(p.detach().numpy(), k), np.asarray(ref_params[k]), atol=1e-7, rtol=0,
                                       err_msg=k)
    return opt, port


def test_adamw_8bit_three_steps_match_jax(monkeypatch):
    opt, port = _run("adamw-bnb-8bit", 3, monkeypatch)
    kernel = opt.inner.state[port["kernel"]]
    assert kernel["mu_codes"].dtype == torch.int8 and kernel["mu_scales"].shape == (1, 64)
    # int8 codes and one fp32 scale per JAX row for the kernel; fp32 moments for the small ones.
    assert opt.inner.state_bytes() == 2 * (64 * 256 + 64 * 4) + 2 * 4 * (64 * 8 + 256)


def test_adam_8bit_step_matches_jax(monkeypatch):
    _run("adam-bnb-8bit", 1, monkeypatch)


def test_min_size_from_the_environment(monkeypatch):
    monkeypatch.setenv("FINETRAINERS_8BIT_MIN_SIZE", "256")
    p = torch.nn.Parameter(torch.zeros(256))
    opt = Adam8bit([p], lr=1e-3)
    assert opt.min_8bit_size == 256 and opt.is_8bit(p)
    monkeypatch.delenv("FINETRAINERS_8BIT_MIN_SIZE")
    assert not Adam8bit([p], lr=1e-3).is_8bit(p)


def test_jax_row_dims_name_the_linear_weights():
    from finetrainers_tpu_torch.models.layers import LayerNorm, LoRADense

    module = torch.nn.Sequential(LoRADense(8, 16, rank=2, dtype=torch.float32), LayerNorm(16, elementwise_affine=True))
    names = [n for n, _ in module.named_parameters()]
    dims = dict(zip(names, jax_row_dims(module, names)))
    assert dims == {"0.weight": 0, "0.bias": -1, "0.lora_A.weight": 0, "0.lora_B.weight": 0, "1.weight": -1,
                    "1.bias": -1}


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_full_precision_optimizers_take_quant_dims(name):
    opt = get_optimizer(name, [torch.nn.Parameter(torch.zeros(2))], 1e-3, quant_dims=[-1])
    assert not isinstance(opt.inner, Adam8bit)
