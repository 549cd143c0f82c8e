"""K2/K3 and K4 parity: the port's flash backward against the JAX Pallas kernels.

The JAX `_flash_backward` runs the Pallas `_bwd_dkdv_kernel` and
`_bwd_dq_kernel` in interpret mode on the CPU, from `out`/LSE of its own
`_flash_forward`; the port's `flash_backward` takes its plain PyTorch version
for CPU tensors, on the same numpy inputs and the same `out`/LSE. The cases
are those of `test_torch_flash_attention.py`. fp32, dq/dk/dv compared at atol
2e-5, rtol 1e-5 (fp32 sums in another order). The K4 glue is held against
`jax.grad` of the JAX `flash_attention` (its `custom_vjp`). The on-card check of
the CUDA kernels against the plain version is in `test_torch_kernels_gpu.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_attention import CASES, _bnsh_tables, _inputs, _j, _t

from finetrainers_tpu.ops.flash_attention import _flash_backward as jax_flash_backward
from finetrainers_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from finetrainers_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from finetrainers_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_backward,
    flash_bwd_dkdv,
    flash_bwd_dq,
    flash_qk_prep,
    flash_forward,
)

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5


def _counters():
    return (flash_forward.launches, flash_qk_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches)


@functools.partial(jax.jit, static_argnames=("scale",))
def _jax_fwd_bwd(q, k, v, kv_lens, cos, sin, do, scale):
    out, lse = jax_flash_forward(q, k, v, kv_lens, None, None, None, scale, False, 256, 256,
                                 rope_cos=cos, rope_sin=sin)
    grads = jax_flash_backward(q, k, v, kv_lens, None, None, None, out, lse, do, scale, False, 256, 256,
                               rope_cos=cos, rope_sin=sin)
    return out, lse, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_jax(case):
    q, k, v, kv_lens, cos, sin = _inputs(case)
    n, h = q.shape[2], q.shape[3]
    qb, kb, vb = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    do = np.random.RandomState(3).randn(*qb.shape).astype(np.float32)
    cos_b, sin_b = _bnsh_tables(cos, sin, n, h)
    out, lse, ref = _jax_fwd_bwd(_j(qb), _j(kb), _j(vb), _j(kv_lens), _j(cos_b), _j(sin_b), _j(do), scale=h**-0.5)
    before = _counters()
    grads = flash_backward(_t(qb), _t(kb), _t(vb), _t(np.asarray(out)), _t(np.asarray(lse)), _t(do),
                           kv_lens=_t(kv_lens), rope_cos=_t(cos_b), rope_sin=_t(sin_b))
    assert _counters() == before, "a CPU call must not count as a kernel launch"
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("case", ["cross_kv_lens_with_zero", "self_rope_full_inner_dim"])
def test_flash_attention_grads_match_jax_grad(case):
    """K4 through the BTNH interface: torch.autograd.grad of sum(out * g)
    against jax.grad of the same through the JAX custom_vjp (one case per
    branch: kv_lens with an empty row, fused RoPE)."""
    q, k, v, kv_lens, cos, sin = _inputs(case)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, kv_lens=_j(kv_lens), rope_cos=_j(cos), rope_sin=_j(sin))
        return jnp.sum(out * jnp.asarray(g))

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    before = _counters()
    out = flash_attention(*leaves, kv_lens=_t(kv_lens), rope_cos=_t(cos), rope_sin=_t(sin))
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionFunctionBackward"
    grads = torch.autograd.grad((out * _t(g)).sum(), leaves)
    assert _counters() == before, "a CPU call must not count as a kernel launch"
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=name)


def test_empty_row_gets_zero_finite_gradients():
    """kv_lens[b] == 0: the LSE is -1e30*ln2, where exp2 overflows; the plain
    backward selects instead of multiplying, so batch b gets exact zeros."""
    q, k, v, kv_lens, _, _ = _inputs("cross_kv_lens_with_zero")
    qb, kb, vb = (_t(x.transpose(0, 2, 1, 3).copy()) for x in (q, k, v))
    out, lse = flash_forward(qb, kb, vb, kv_lens=_t(kv_lens))
    grads = flash_backward(qb, kb, vb, out, lse, torch.ones_like(qb), kv_lens=_t(kv_lens))
    for grad in grads:
        assert torch.isfinite(grad).all()
        assert not grad[2].any()
    dk, dv = grads[1], grads[2]
    assert not dk[1, :, 7:].any() and not dv[1, :, 7:].any()  # keys past kv_lens[1] = 7
