"""K5 parity: the port's fused flash backward against the JAX Pallas kernel.

With FINETRAINERS_FLASH_FUSED_BWD=1 the JAX `_flash_backward` runs the Pallas
`_bwd_fused_kernel` in interpret mode on the CPU (traced afresh in each test
with the switch set by `monkeypatch`, so no cached trace ignores it, and
compiled at XLA's lowest level, `jax_compiled`); the port's
`flash_backward` then takes K5's plain version, `flash_backward_fused_reference`,
for CPU tensors. Same numpy inputs and the same `out`/LSE from the JAX forward;
fp32, dq/dk/dv compared at atol 2e-5, rtol 1e-5 (fp32 sums in another order:
128-key tiles here, the Pallas kernel's blocks there), as for K2/K3. The cases
over 128 keys run JAX at 32- and 128-key blocks. Head dims 32 (the dummy
family's: 2 heads, its self-attention and its cross-attention over 16 caption
slots), 64 and 128. The K4 glue under
the switch is held against `jax.grad` of the JAX `flash_attention`. The on-card
check of the CUDA kernel against the plain version is in
`test_torch_kernels_gpu.py`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compiled import compiled
from test_torch_flash_attention import _bnsh_tables, _j, _ltx_tables, _shared_tables, _t

from finetrainers_tpu.ops.flash_attention import _flash_backward as jax_flash_backward
from finetrainers_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from finetrainers_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from finetrainers_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_backward,
    flash_backward_fused_reference,
    flash_backward_reference,
    flash_bwd_dq_emit,
    flash_bwd_fused,
)

torch.set_num_threads(1)
port_flash_ops = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")
jax_flash_ops = importlib.import_module("finetrainers_tpu.ops.flash_attention")

ATOL, RTOL = 2e-5, 1e-5
SWITCH = "FINETRAINERS_FLASH_FUSED_BWD"

# name: (B, N, Sq, Skv, H, rope, kv_lens).
CASES = {
    "per_head_tables_h64": (2, 2, 96, 96, 64, "ltx", None),
    "shared_tables_h128": (1, 2, 80, 80, 128, "shared", None),
    "kv_lens_with_empty_row": (3, 2, 40, 90, 64, None, [90, 7, 0]),
    "cross_sq_ne_skv": (2, 2, 50, 140, 64, None, None),
    "dummy_self_h32": (1, 2, 72, 72, 32, None, None),
    "dummy_cross_kv_lens_empty_row_h32": (2, 2, 72, 16, 32, None, [16, 0]),
}
# Over 128 keys, so K5's plain version adds dq over more than one of its 128-key
# tiles: ragged last tiles (300 = 2*128 + 44, 333, 260), kv_lens inside the
# second tile (150) and an empty row.
CASES_OVER_128 = {
    "ragged_last_tile_h64": (1, 2, 70, 300, 64, None, None),
    "kv_lens_across_tiles_empty_row_h128": (3, 2, 50, 333, 128, None, [333, 150, 0]),
    "shared_tables_ragged_h64": (1, 2, 260, 260, 64, "shared", None),
    "shared_tables_kv_lens_ragged_h32": (2, 2, 300, 300, 32, "shared", [290, 131]),
}
CASES.update(CASES_OVER_128)


def _inputs(case):
    b, n, sq, skv, h, rope, lens = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q, k, v = (rng.randn(b, s, n, h).astype(np.float32) for s in (sq, skv, skv))
    cos = sin = None
    if rope == "ltx":
        cos, sin = _ltx_tables(n, h, (2, 4, sq // 8))
    elif rope == "shared":
        cos, sin = _shared_tables(sq, h, rng)
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, kv_lens, cos, sin


@pytest.fixture
def fused_kernel_traces(monkeypatch):
    """Set the switch and count the traces of the Pallas `_bwd_fused_kernel`."""
    monkeypatch.setenv(SWITCH, "1")
    traces = []
    kernel = jax_flash_ops._bwd_fused_kernel
    monkeypatch.setattr(jax_flash_ops, "_bwd_fused_kernel", lambda *a, **kw: traces.append(1) or kernel(*a, **kw))
    return traces


def _check_against_jax(case, jax_block_kv, traces):
    q, k, v, kv_lens, cos, sin = _inputs(case)
    n, h = q.shape[2], q.shape[3]
    qb, kb, vb = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    do = np.random.RandomState(3).randn(*qb.shape).astype(np.float32)
    cos_b, sin_b = _bnsh_tables(cos, sin, n, h)

    def jax_fwd_bwd(q, k, v, lens, cos, sin, do):
        out, lse = jax_flash_forward(q, k, v, lens, None, None, None, h**-0.5, False, 32, 32, rope_cos=cos,
                                     rope_sin=sin)
        return out, lse, jax_flash_backward(q, k, v, lens, None, None, None, out, lse, do, h**-0.5, False, 32,
                                            jax_block_kv, rope_cos=cos, rope_sin=sin)

    out, lse, ref = compiled(jax_fwd_bwd, _j(qb), _j(kb), _j(vb), _j(kv_lens), _j(cos_b), _j(sin_b), _j(do))
    assert traces, "the JAX backward did not take its fused kernel"
    before = (flash_bwd_fused.launches, flash_bwd_dq_emit.launches)
    grads = flash_backward(_t(qb), _t(kb), _t(vb), _t(np.asarray(out)), _t(np.asarray(lse)), _t(do),
                           kv_lens=_t(kv_lens), rope_cos=_t(cos_b), rope_sin=_t(sin_b))
    assert (flash_bwd_fused.launches, flash_bwd_dq_emit.launches) == before, "a CPU call is no kernel launch"
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=name)
    if kv_lens is not None and 0 in kv_lens:
        empty = list(kv_lens).index(0)
        assert all(torch.isfinite(g).all() and not g[empty].any() for g in grads)


@pytest.mark.parametrize("case", sorted(set(CASES) - set(CASES_OVER_128)))
def test_fused_backward_matches_jax(case, fused_kernel_traces):
    _check_against_jax(case, 32, fused_kernel_traces)


@pytest.mark.parametrize("jax_block_kv", [32, 128])
@pytest.mark.parametrize("case", sorted(CASES_OVER_128))
def test_fused_backward_over_128_key_tiles_matches_jax(case, jax_block_kv, fused_kernel_traces):
    """K5's plain version sums dq over its 128-key tiles in turn; JAX's fused
    kernel at 32- and 128-key blocks."""
    _check_against_jax(case, jax_block_kv, fused_kernel_traces)


@pytest.mark.parametrize("case", ["kv_lens_with_empty_row", "per_head_tables_h64"])
def test_k4_backward_takes_the_fused_path(case, fused_kernel_traces, monkeypatch):
    """`loss.backward()` through K4 under the switch against `jax.grad` through
    the JAX custom_vjp under the same switch; the port's backward must be K5's
    plain version."""
    q, k, v, kv_lens, cos, sin = _inputs(case)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, kv_lens=_j(kv_lens), rope_cos=_j(cos), rope_sin=_j(sin))
        return jnp.sum(out * jnp.asarray(g))

    ref = compiled(jax.grad(loss, argnums=(0, 1, 2)), _j(q), _j(k), _j(v))
    assert fused_kernel_traces
    calls = []
    monkeypatch.setattr(port_flash_ops, "flash_backward_fused_reference",
                        lambda *a, **kw: calls.append(1) or flash_backward_fused_reference(*a, **kw))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, kv_lens=_t(kv_lens), rope_cos=_t(cos), rope_sin=_t(sin))
    (out * _t(g)).sum().backward()
    assert calls == [1]
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=name)


def test_fused_plain_version_matches_the_split_one():
    """K5's and K2/K3's plain versions compute the same gradients (fp32 sums in
    another order), with the switch off."""
    q, k, v, kv_lens, cos, sin = _inputs("shared_tables_h128")
    qb, kb, vb = (_t(x.transpose(0, 2, 1, 3).copy()) for x in (q, k, v))
    cos_b, sin_b = _bnsh_tables(cos, sin, q.shape[2], q.shape[3])
    do = torch.from_numpy(np.random.RandomState(5).randn(*qb.shape).astype(np.float32))
    out, lse = flash_attention_reference(qb, kb, vb, None, _t(cos_b), _t(sin_b))
    split = flash_backward_reference(qb, kb, vb, out, lse, do, None, _t(cos_b), _t(sin_b))
    fused = flash_backward_fused_reference(qb, kb, vb, out, lse, do, None, _t(cos_b), _t(sin_b))
    for got, want in zip(fused, split):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
