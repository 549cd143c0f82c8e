"""The multistep samplers and `load_scheduler`: JAX `schedulers.py` against the port.

The per-step coefficients are float64 numpy on both sides (the port's are
copies) and must be equal. The samplers run a 6-step denoise over random fp32
arrays from a seeded numpy draw (a sample and one model output per step),
each step's output held within atol 1e-6, rtol 1e-5: both form the update as
an fp32 linear combination with fp32 coefficients, and XLA may contract a
multiply and an add where torch rounds twice (1 ulp per term). UniPC runs
bh1 and bh2 at orders 1-3 with the corrector on and off, over the pipelines'
grid from sigma 1 and a grid from 0.95 (bh1's corrector is NaN from sigma 1
in both packages), DPM-Solver++ at orders 1 and 2, and both with and without
`lower_order_final`.
`load_scheduler` is held against JAX's for every class name it maps, from a
`scheduler/scheduler_config.json` written into `tmp_path`.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu import schedulers as jax_schedulers
from finetrainers_tpu_torch import schedulers

torch.set_num_threads(1)

SHAPE = (1, 4, 3, 4, 6)
STEPS = 6


def _grid(shift=3.0, start=1.0):
    """The pipelines' grid (`inference_sigmas`, from sigma 1), or the same
    shifted grid from `start` < 1, where every lambda is finite."""
    if start == 1.0:
        return schedulers.FlowMatchEulerScheduler(shift=shift).inference_sigmas(STEPS)
    t = np.linspace(start, 1.0 / STEPS, STEPS)
    return np.concatenate([shift * t / (1.0 + (shift - 1.0) * t), [0.0]]).astype(np.float32)


def _run(jax_sampler, port_sampler, seed=0):
    rng = np.random.RandomState(seed)
    sample = rng.randn(*SHAPE).astype(np.float32)
    preds = [rng.randn(*SHAPE).astype(np.float32) for _ in range(STEPS)]
    x_jax, x_port = jnp.asarray(sample), torch.from_numpy(sample)
    for i, pred in enumerate(preds):
        x_jax = jax_sampler.update(jnp.asarray(pred), i, x_jax)
        x_port = port_sampler.update(torch.from_numpy(pred), i, x_port)
        assert x_port.dtype == torch.float32
        np.testing.assert_allclose(x_port.numpy(), np.asarray(x_jax), atol=1e-6, rtol=1e-5, err_msg=f"step {i}")
    return x_port


@pytest.mark.parametrize("shift", [1.0, 3.0, 5.0])
def test_inference_sigmas_equal(shift):
    ref = jax_schedulers.UniPCFlowScheduler(shift=shift).inference_sigmas(STEPS)
    np.testing.assert_array_equal(schedulers.UniPCFlowScheduler(shift=shift).inference_sigmas(STEPS), ref)


@pytest.mark.parametrize("solver_type", ["bh1", "bh2"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_unipc_coefficients_equal(order, solver_type):
    sigmas = _grid()
    for i in range(STEPS):
        np.testing.assert_array_equal(schedulers._uni_p_coeffs(sigmas, i, order, solver_type),
                                      jax_schedulers._uni_p_coeffs(sigmas, i, order, solver_type))
        if i > 0:
            np.testing.assert_array_equal(schedulers._uni_c_coeffs(sigmas, i, order, solver_type),
                                          jax_schedulers._uni_c_coeffs(sigmas, i, order, solver_type))
    for order_dpm in (1, 2):
        for i in range(1, STEPS):
            np.testing.assert_array_equal(schedulers._dpm_coeffs(sigmas, i, order_dpm),
                                          jax_schedulers._dpm_coeffs(sigmas, i, order_dpm))


@pytest.mark.parametrize("start", [1.0, 0.95], ids=["from_1", "from_0.95"])
@pytest.mark.parametrize("use_corrector", [True, False], ids=["corrector", "no_corrector"])
@pytest.mark.parametrize("solver_type", ["bh1", "bh2"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_unipc_updates_match_jax(order, solver_type, use_corrector, start):
    sigmas = _grid(start=start)
    ref = jax_schedulers.UniPCSampler(sigmas, order, solver_type, True, use_corrector)
    port = schedulers.UniPCSampler(sigmas, order, solver_type, True, use_corrector)
    out = _run(ref, port)
    # bh1's B(h) = h is infinite on the step from sigma 1 (lambda = -inf), so its
    # first corrector gives NaN in JAX, and in the port too (bh2's is expm1(h) = -1).
    assert torch.isfinite(out).all() != (solver_type == "bh1" and use_corrector and start == 1.0)
    # The history is the run's own and holds at most `order` x0 predictions.
    assert len(port.history) == order and port.history is not ref.history


@pytest.mark.parametrize("lower_order_final", [True, False])
def test_unipc_lower_order_final_matches_jax(lower_order_final):
    sigmas = _grid(shift=5.0)
    _run(jax_schedulers.UniPCSampler(sigmas, 3, "bh2", lower_order_final, True),
         schedulers.UniPCSampler(sigmas, 3, "bh2", lower_order_final, True), seed=1)


@pytest.mark.parametrize("lower_order_final", [True, False])
@pytest.mark.parametrize("order", [1, 2])
def test_dpm_solver_updates_match_jax(order, lower_order_final):
    sigmas = _grid()
    _run(jax_schedulers.DPMSolverSampler(sigmas, order, lower_order_final),
         schedulers.DPMSolverSampler(sigmas, order, lower_order_final), seed=2)


def test_samplers_are_per_request():
    """Two runs from one scheduler keep separate histories: the second run's
    first step does not see the first run's model outputs."""
    sched = schedulers.UniPCFlowScheduler(shift=3.0)
    sigmas = sched.inference_sigmas(STEPS)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    pred = torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
    first = sched.make_sampler(sigmas)
    a = first.update(pred, 0, x)
    first.update(pred, 1, a)
    second = sched.make_sampler(sigmas)
    assert torch.equal(second.update(pred, 0, x), a) and len(second.history) == 1


_CONFIGS = {
    "UniPCMultistepScheduler": dict(flow_shift=3.0, solver_order=2, solver_type="bh2"),
    "FlowUniPCMultistepScheduler": dict(shift=5.0, solver_order=3, solver_type="bh1", lower_order_final=False,
                                        disable_corrector=[0]),
    "DPMSolverMultistepScheduler": dict(flow_shift=2.0, solver_order=2),
    "FlowDPMSolverMultistepScheduler": dict(solver_order=1, lower_order_final=False),
    "FlowMatchEulerDiscreteScheduler": dict(shift=7.0, num_train_timesteps=500),
    "CogVideoXDDIMScheduler": dict(beta_start=0.001),
    "DDIMScheduler": dict(),
    "SomethingElse": dict(shift=9.0),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_load_scheduler_matches_jax(name, tmp_path):
    (tmp_path / "scheduler").mkdir()
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(json.dumps({"_class_name": name, **_CONFIGS[name]}))
    ref = jax_schedulers.load_scheduler(str(tmp_path), default=jax_schedulers.FlowMatchEulerScheduler(shift=3.0))
    default = schedulers.FlowMatchEulerScheduler(shift=3.0)
    got = schedulers.load_scheduler(str(tmp_path), default=default)
    assert type(got).__name__ == type(ref).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if type(ref) is jax_schedulers.FlowMatchEulerScheduler and name != "FlowMatchEulerDiscreteScheduler":
        assert got is default  # DDIM under a flow-matching family and unknown names keep the family default
    assert type(got.make_sampler(got.inference_sigmas(4))).__name__ == type(
        ref.make_sampler(ref.inference_sigmas(4))).__name__


def test_load_scheduler_without_a_config_keeps_the_default(tmp_path):
    default = schedulers.FlowMatchEulerScheduler(shift=3.0)
    for path in (None, "", str(tmp_path), "Wan-AI/Wan2.1-T2V-1.3B-Diffusers"):
        assert schedulers.load_scheduler(path, default=default) is default
