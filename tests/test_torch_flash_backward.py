"""K2/K3 and K4 parity: the port's flash backward against the JAX Pallas kernels.

The JAX `_flash_backward` runs the Pallas `_bwd_dkdv_kernel` and
`_bwd_dq_kernel` in interpret mode on the CPU, from `out`/LSE of its own
`_flash_forward`; the port's `flash_backward` takes its plain PyTorch version
for CPU tensors, on the same numpy inputs and the same `out`/LSE. The cases
are those of `test_torch_flash_attention.py`. fp32, dq/dk/dv compared at atol
2e-5, rtol 1e-5 (fp32 sums in another order). K2's and K3's own plain versions
(`flash_bwd_dkdv_reference`, `flash_bwd_dq_reference`, on the pre-pass's
operands), with K2's q loop cut as `dkdv_splits` cuts it for cross-attention,
are held against the same JAX gradients. The K4 glue is held against
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
    dkdv_splits,
    flash_attention,
    flash_backward,
    flash_bwd_dkdv,
    flash_bwd_dkdv_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    flash_forward,
    flash_qk_prep,
    flash_qk_prep_reference,
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


def _plain_operands(q, k, v, kv_lens, cos_b, sin_b, do):
    """JAX's out, LSE and gradients, and the pre-pass's operands and delta for the port's plain K2/K3."""
    n, h = q.shape[2], q.shape[3]
    qb, kb, vb = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    out, lse, ref = _jax_fwd_bwd(_j(qb), _j(kb), _j(vb), _j(kv_lens), _j(cos_b), _j(sin_b), _j(do), scale=h**-0.5)
    q_s, k_r = flash_qk_prep_reference(_t(qb), _t(kb), _t(cos_b), _t(sin_b), h**-0.5)
    out, do_t = _t(np.asarray(out)), _t(do)
    operands = (q_s, k_r, _t(vb), do_t, _t(np.asarray(lse)), (do_t * out).sum(-1), _t(kv_lens), _t(cos_b), _t(sin_b))
    return operands, [np.asarray(x) for x in ref]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k2_k3_match_jax(case):
    """K2's and K3's plain versions on the pre-pass's operands against JAX
    `_flash_backward`; on CPU tensors the K2/K3 wrappers compute them and count
    no launch."""
    q, k, v, kv_lens, cos, sin = _inputs(case)
    n, h = q.shape[2], q.shape[3]
    cos_b, sin_b = _bnsh_tables(cos, sin, n, h)
    do = np.random.RandomState(5).randn(q.shape[0], n, q.shape[1], h).astype(np.float32)
    operands, (ref_dq, ref_dk, ref_dv) = _plain_operands(q, k, v, kv_lens, cos_b, sin_b, do)
    dk, dv = flash_bwd_dkdv_reference(*operands)
    dq = flash_bwd_dq_reference(*operands, h**-0.5)
    for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)
    before = _counters()
    wrapped = (*flash_bwd_dkdv(*operands, 0), flash_bwd_dq(*operands, 0, h**-0.5))
    assert _counters() == before, "a CPU call must not count as a kernel launch"
    for got, want in zip(wrapped, (dk, dv, dq)):
        assert torch.equal(got, want)


# A long q side over few keys, where K2 cuts its q loop over several CTAs (64-row q tiles).
SPLIT_CASE = (1, 2, 700, 77, 64, [50])


@pytest.mark.parametrize("splits", [1, 3, 11])
def test_plain_k2_with_a_split_q_loop_matches_jax(splits):
    """K2's plain version with its q loop cut into `splits` ranges of whole q
    tiles, each range's fp32 partial dk and dv summed as K2's reduce pass sums
    them, against JAX `_flash_backward` (kv_lens leaves keys 50..76 masked)."""
    b, n, sq, skv, h, lens = SPLIT_CASE
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(b, s, n, h).astype(np.float32) for s in (sq, skv, skv))
    do = rng.randn(b, n, sq, h).astype(np.float32)
    operands, (_, ref_dk, ref_dv) = _plain_operands(q, k, v, np.asarray(lens, np.int32), None, None, do)
    dk, dv = flash_bwd_dkdv_reference(*operands, splits=splits)
    np.testing.assert_allclose(dk.numpy(), ref_dk, atol=ATOL, rtol=RTOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), ref_dv, atol=ATOL, rtol=RTOL, err_msg="dv")
    assert not dk[:, :, 50:].any() and not dv[:, :, 50:].any()


@pytest.mark.parametrize("shape, expected", [
    ((1, 12, 19968, 19968), (1, 312)),  # Wan train self-attention: 1872 kv-tile CTAs fill the card
    ((1, 12, 19968, 512), (8, 39)),     # Wan train cross-attention: 48 CTAs, cut 8 ways
    ((1, 32, 2688, 2688), (1, 42)),     # LTX train self-attention
    ((1, 32, 2688, 128), (4, 11)),      # LTX train cross-attention: 32 CTAs, cut 4 ways
    ((2, 4, 1000, 77), (8, 2)),
])
def test_dkdv_splits_at_the_main_paths_shapes(shape, expected):
    """K2's cut of its q loop on a 132-SM card: none where the kv tiles fill
    the card; otherwise at most 8 ranges of at least 2 whole q tiles that
    cover the q side, none empty."""
    splits, per = dkdv_splits(*shape, 132)
    assert (splits, per) == expected
    q_tiles = -(-shape[2] // 64)
    assert (splits - 1) * per < q_tiles <= splits * per
    assert splits == 1 or (2 <= per and splits <= 8)
