"""Head dim 32 (the dummy family's): K1's, the pre-pass's, K2's (its q loop
cut as `dkdv_splits` cuts it) and K3's plain versions against the JAX Pallas
kernels in interpret mode, and the head-dim gate of each kernel wrapper.

The Pallas kernels take any head dim; every kernel of the port (K1-K3, K5
and its dq emit, K7a/b/c, both pre-passes and K6) and every branch takes 32,
64 and 128 through one gate (`HEAD_DIMS`). K5's, K7's and K6's plain versions
at 32 are held against JAX in their own files. Cases: the dummy's
self-attention (72 tokens) and cross-attention (16 caption slots, kv_lens with
an empty row), shared RoPE tables off every tile boundary, and a ragged
300-token case. fp32, compared at atol 2e-5, rtol 1e-5 (fp32 sums in another
order), as the other head dims are in test_torch_flash_attention.py and
test_torch_flash_backward.py. The gates are checked on meta tensors: a
wrapper refuses a head dim it does not take before it looks at the device,
so a head dim it takes reaches the device check.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compiled import compiled
from test_torch_flash_attention import _shared_tables

from finetrainers_tpu.ops.flash_attention import _flash_backward as jax_flash_backward
from finetrainers_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from finetrainers_tpu_torch.ops import attention as attention_ops
from finetrainers_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    flash_backward,
    flash_bwd_dkdv_reference,
    flash_bwd_dq_reference,
    flash_forward,
    flash_forward_skew,
    flash_forward_two_level,
    flash_forward_twopass,
    flash_qk_prep_reference,
)
from finetrainers_tpu_torch.ops.sage_attention import sage_forward, sage_prep

port_fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")
port_sage = importlib.import_module("finetrainers_tpu_torch.ops.sage_attention")

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
# name: (B, N, Sq, Skv, rope, kv_lens), H = 32
CASES = {
    "dummy_self": (1, 2, 72, 72, None, None),
    "dummy_cross_kv_lens_with_zero": (2, 2, 72, 16, None, [16, 0]),
    "shared_rope_37": (1, 3, 37, 37, "shared", None),
    "ragged_300": (2, 2, 300, 300, None, [290, 131]),
}


def _inputs(case):
    b, n, sq, skv, rope, lens = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q, k, v = (rng.randn(b, n, s, 32).astype(np.float32) for s in (sq, skv, skv))
    do = rng.randn(b, n, sq, 32).astype(np.float32)
    cos = sin = None
    if rope:
        cos, sin = (t[None] for t in _shared_tables(sq, 32, rng))
    return q, k, v, do, None if lens is None else np.asarray(lens, np.int32), cos, sin


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax(case):
    q, k, v, do, lens, cos, sin = _inputs(case)

    def run(q, k, v, lens, cos, sin, do):
        out, lse = jax_flash_forward(q, k, v, lens, None, None, None, 32**-0.5, False, 256, 256,
                                     rope_cos=cos, rope_sin=sin)
        grads = jax_flash_backward(q, k, v, lens, None, None, None, out, lse, do, 32**-0.5, False, 256, 256,
                                   rope_cos=cos, rope_sin=sin)
        return out, lse, grads

    out, lse, grads = compiled(run, *map(_j, (q, k, v, lens, cos, sin, do)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_h32_forward_matches_jax(case):
    q, k, v, _, lens, cos, sin = _inputs(case)
    ref_out, ref_lse, _ = _jax(case)
    launches = flash_forward.launches
    out, lse = flash_forward(_t(q), _t(k), _t(v), kv_lens=_t(lens), rope_cos=_t(cos), rope_sin=_t(sin))
    assert flash_forward.launches == launches, "a CPU call must not count as a kernel launch"
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_h32_backward_and_plain_k2_k3_match_jax(case):
    """`flash_backward` and K2's (with `splits` as `dkdv_splits` cuts the dummy's
    q loop: 7 or 8 on an H100) and K3's plain versions on the pre-pass's operands."""
    q, k, v, do, lens, cos, sin = _inputs(case)
    ref_out, ref_lse, (ref_dq, ref_dk, ref_dv) = _jax(case)
    grads = flash_backward(_t(q), _t(k), _t(v), _t(ref_out), _t(ref_lse), _t(do), kv_lens=_t(lens),
                           rope_cos=_t(cos), rope_sin=_t(sin))
    for name, got, want in zip(("dq", "dk", "dv"), grads, (ref_dq, ref_dk, ref_dv)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)
    q_s, k_r = flash_qk_prep_reference(_t(q), _t(k), _t(cos), _t(sin), 32**-0.5)
    operands = (q_s, k_r, _t(v), _t(do), _t(ref_lse), (_t(do) * _t(ref_out)).sum(-1), _t(lens), _t(cos), _t(sin))
    dq = flash_bwd_dq_reference(*operands, 32**-0.5)
    np.testing.assert_allclose(dq.numpy(), ref_dq, atol=ATOL, rtol=RTOL)
    for splits in (1, 8):
        dk, dv = flash_bwd_dkdv_reference(*operands, splits=splits)
        np.testing.assert_allclose(dk.numpy(), ref_dk, atol=ATOL, rtol=RTOL, err_msg=f"dk, {splits} splits")
        np.testing.assert_allclose(dv.numpy(), ref_dv, atol=ATOL, rtol=RTOL, err_msg=f"dv, {splits} splits")


def _meta(b, n, s, h, dtype=torch.bfloat16):
    return torch.empty(b, n, s, h, dtype=dtype, device="meta")


def test_one_head_dim_set_for_every_kernel():
    """One gate: no kernel keeps a head-dim set of its own."""
    assert HEAD_DIMS == (32, 64, 128)
    for name in ("K1_HEAD_DIMS", "WIDE_HEAD_DIMS", "BRANCH_HEAD_DIMS"):
        assert not hasattr(port_fa, name)
        assert not hasattr(port_sage, name)


@pytest.mark.parametrize("wrapper", [flash_forward_twopass, flash_forward_two_level, flash_forward_skew],
                         ids=["k7a", "k7c", "k7b"])
def test_k7_variants_take_head_dim_32_and_refuse_48_and_256(wrapper):
    with pytest.raises(ValueError, match="unsupported device"):  # past the head-dim gate; the device is next
        wrapper(*(_meta(1, 2, 64, 32),) * 3)
    for head_dim in (48, 256):
        with pytest.raises(ValueError, match=f"head dim {head_dim}"):
            wrapper(*(_meta(1, 2, 64, head_dim),) * 3)


def test_k1_k2_k3_and_k5_take_head_dim_32(monkeypatch):
    q = _meta(1, 2, 64, 32)
    with pytest.raises(ValueError, match="unsupported device"):  # past the head-dim gate
        flash_forward(q, q, q)
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_backward(q, q, q, q, lse, q)
    monkeypatch.setenv("FINETRAINERS_FLASH_FUSED_BWD", "1")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_backward(q, q, q, q, lse, q)
    for head_dim in (48, 256):
        x = _meta(1, 2, 64, head_dim)
        with pytest.raises(ValueError, match=f"head dim {head_dim}"):
            flash_forward(x, x, x)
        with pytest.raises(ValueError, match=f"head dim {head_dim}"):
            flash_backward(x, x, x, x, lse, x)


def test_k6_and_its_prepass_take_head_dim_32():
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    scales = torch.empty(1, 2, 64, device="meta")
    for head_dim, match in ((32, "unsupported device"), (48, "head dim 48"), (256, "head dim 256")):
        x = torch.empty(1, 64, 2, head_dim, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match=match):
            sage_prep(x, x, lens)
        codes = torch.empty(1, 2, 64, head_dim, dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match=match):
            sage_forward(codes, codes, scales, scales, _meta(1, 2, 64, head_dim))


@pytest.mark.parametrize("head_dim,takes", [(32, True), (64, True), (128, True), (48, False), (256, False)])
def test_k1_takes_head_dim_32_on_the_card(head_dim, takes):
    q = torch.empty(1, 64, 2, head_dim, dtype=torch.bfloat16, device="meta")
    assert attention_ops._k1_takes(q, q, None, False) is takes
    assert attention_ops._k1_takes(q.float(), q.float(), None, False) is False  # fp32 never on the card
