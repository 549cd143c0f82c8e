"""The sage pre-pass with fused RoPE: the port's plain version against the JAX package.

The pre-pass rotates q and k with the RoPE tables (in fp32, rounded back to
their dtype), smooths k (its fp32 mean over the valid prefix subtracted) and
quantizes both per token to int8. The JAX package computes the same function
in XLA: the dispatcher's `_rotate_interleaved_4d` before the kernel, then
`_sage_impl`'s smooth-K (:112-118) and `_quantize_per_token` (:96-103). The
port's plain version (`sage_quantize`, which `sage_prep` computes on a CPU
tensor) takes the tables in the kernel's (N or 1, S, H) form. Inputs are
seeded numpy at small shapes off the 128-row tile, k with a channel offset
that smooth-K removes.

Tolerances:
  - q codes and scales equal: the rotation is three separately rounded fp32
    operations in both (torch's and XLA's on the CPU give the same bits here),
    and both divide with IEEE division and round half to even;
  - k codes within one, different in at most 0.1% of entries, and k scales
    within rtol 1e-5: the smoothed k's mean is summed in another order;
  - dispatch with `rope_freqs` under each sage name against JAX's
    `attention_dispatch`: atol 1e-5 in fp32, atol and rtol 1e-2 in bf16 (about
    two bf16 units in the last place; as `test_torch_sage_attention.py`).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.ops import attention_dispatch as jax_attention_dispatch
from finetrainers_tpu.ops.attention import _rotate_interleaved_4d as jax_rotate
from finetrainers_tpu.ops.sage_attention import _quantize_per_token as jax_quantize
from finetrainers_tpu_torch.ops import attention_dispatch
from finetrainers_tpu_torch.ops.flash_attention import kernel_tables
from finetrainers_tpu_torch.ops.sage_attention import sage_prep, sage_quantize

sage_ops = importlib.import_module("finetrainers_tpu_torch.ops.sage_attention")
attention_ops = importlib.import_module("finetrainers_tpu_torch.ops.attention")

torch.set_num_threads(1)

SAGE_NAMES = ("sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda", "_sage_qk_int8_pv_fp16_triton",
              "_sage_qk_int8_pv_fp8_cuda", "_sage_qk_int8_pv_fp8_cuda_sm90")
TOLS = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(b, s, n, h, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, n, h).astype(np.float32) for _ in range(3))
    return q, k + 1.5 * rng.randn(1, 1, n, h).astype(np.float32), v


def _tables(s, n, h, per_head, seed):
    """Interleaved-pair tables, (S, N*H) full-inner-dim or (S, H) shared."""
    ang = np.random.RandomState(seed).uniform(0, 2 * np.pi, (s, (n if per_head else 1) * h // 2))
    return tuple(np.repeat(f(ang), 2, -1).astype(np.float32) for f in (np.cos, np.sin))


def _jax_prepass(q, k, lens, cos, sin, dtype):
    """JAX's rotation, smooth-K and per-token quantization on BTNH arrays ->
    BNSH codes and scales (`_sage_impl` :112-121 after the dispatcher's
    rotation, attention.py:207-209)."""
    qj, kj = (jax_rotate(jnp.asarray(x, JNP[dtype]), jnp.asarray(cos), jnp.asarray(sin)) for x in (q, k))
    qb, kb = jnp.swapaxes(qj, 1, 2), jnp.swapaxes(kj, 1, 2)
    s = kb.shape[2]
    valid = jnp.arange(s)[None, None, :, None] < jnp.asarray(lens)[:, None, None, None]
    denom = jnp.maximum(jnp.asarray(lens).astype(jnp.float32), 1.0)[:, None, None, None]
    k_mean = jnp.sum(jnp.where(valid, kb.astype(jnp.float32), 0.0), axis=2, keepdims=True) / denom
    q_codes, q_scales = jax_quantize(qb)
    k_codes, k_scales = jax_quantize(kb.astype(jnp.float32) - k_mean)
    return [np.asarray(x) for x in (q_codes, k_codes, q_scales, k_scales)], np.asarray(qj.astype(jnp.float32))


def _assert_codes_match(got, ref):
    q_codes, k_codes, q_scales, k_scales = (x.numpy() for x in got)
    np.testing.assert_array_equal(q_codes, ref[0])
    np.testing.assert_array_equal(q_scales, ref[2])
    diff = np.abs(k_codes.astype(np.int32) - ref[1].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(k_scales, ref[3], rtol=1e-5, atol=0)


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_prepass_with_tables_matches_jax(dtype, head_dim, per_head):
    """The plain pre-pass with (S, H) or (S, N*H) tables against JAX's rotation,
    smooth-K and quantization; kv_lens of Skv, of part of it and of 0. The
    rotated q, rounded to the input dtype, is also bit-equal to JAX's."""
    b, s, n = 3, 200, 2
    q, k, _ = _inputs(b, s, n, head_dim, seed=head_dim + per_head)
    cos, sin = _tables(s, n, head_dim, per_head, seed=7)
    lens = np.asarray([s, 77, 0], np.int32)
    ref, q_rotated = _jax_prepass(q, k, lens, cos, sin, dtype)
    tq, tk = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k))
    tables = kernel_tables(tq, tk, torch.from_numpy(cos), torch.from_numpy(sin))
    assert tables[0].shape == ((n if per_head else 1), s, head_dim)
    got = sage_quantize(tq, tk, torch.from_numpy(lens), *tables)
    assert all(x.is_contiguous() for x in got)
    assert [tuple(x.shape) for x in got] == [(b, n, s, head_dim)] * 2 + [(b, n, s)] * 2
    _assert_codes_match(got, ref)
    np.testing.assert_array_equal(sage_ops._rotate(tq, *tables).float().numpy(), q_rotated)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_sage_prep_takes_the_plain_prepass_on_the_cpu(head_dim):
    """On a CPU tensor `sage_prep` computes the plain pre-pass, with and
    without tables, and launches nothing."""
    b, s, n = 2, 130, 3
    q, k, _ = _inputs(b, s, n, head_dim, seed=3)
    tq, tk = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k))
    lens = torch.tensor([s, 1], dtype=torch.int32)
    tables = kernel_tables(tq, tk, *(torch.from_numpy(t) for t in _tables(s, n, head_dim, False, seed=4)))
    before = sage_prep.launches
    for args in ((), tables):
        for x, y in zip(sage_prep(tq, tk, lens, *args), sage_quantize(tq, tk, lens, *args)):
            assert torch.equal(x, y)
    assert sage_prep.launches == before


@pytest.mark.parametrize("name", SAGE_NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sage_dispatch_with_rope_freqs_matches_jax(dtype, name):
    """Every sage name with (S, N*H) tables and kv_lens (one row empty) against
    JAX's dispatch under the same name, which rotates in XLA before its kernel."""
    b, s, n, h = 2, 150, 2, 64
    q, k, v = _inputs(b, s, n, h, seed=11)
    cos, sin = _tables(s, n, h, True, seed=12)
    lens = np.asarray([s, 0], np.int32)
    ref = jax_attention_dispatch(*(jnp.asarray(x, JNP[dtype]) for x in (q, k, v)), kv_lens=jnp.asarray(lens),
                                 provider=name, rope_freqs=(jnp.asarray(cos), jnp.asarray(sin)))
    out = attention_dispatch(*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
                             kv_lens=torch.from_numpy(lens), provider=name,
                             rope_freqs=(torch.from_numpy(cos), torch.from_numpy(sin)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **TOLS[dtype])
    assert not out[1].any()  # no valid key: exact zeros


def test_cpu_sage_path_rotates_exactly_once(monkeypatch):
    """The dispatcher hands the tables to the pre-pass: its own torch rotation
    is never called, and the pre-pass rotates q and k once each."""
    calls = []
    rope_fwd = sage_ops._rope_fwd

    def counting_rope_fwd(x, cos, sin):
        calls.append(tuple(x.shape))
        return rope_fwd(x, cos, sin)

    def no_rotation(*args):
        raise AssertionError("the dispatcher rotated q or k before the sage pre-pass")

    monkeypatch.setattr(sage_ops, "_rope_fwd", counting_rope_fwd)
    monkeypatch.setattr(attention_ops, "_rotate_interleaved_4d", no_rotation)
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 120, 2, 64, seed=13))
    cos, sin = (torch.from_numpy(t) for t in _tables(120, 2, 64, False, seed=14))
    out = attention_dispatch(q, k, v, provider="sage", rope_freqs=(cos, sin))
    assert calls == [tuple(q.shape), tuple(k.shape)] and out.shape == q.shape


def test_sage_rotates_before_plain_math_for_a_causal_call():
    """A causal call takes `_native_math` on the CPU after the same rotation
    (the kernels take no causal call; on the card it raises)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 40, 2, 64, seed=15))
    cos, sin = (torch.from_numpy(t) for t in _tables(40, 2, 64, False, seed=16))
    out = attention_dispatch(q, k, v, is_causal=True, provider="sage", rope_freqs=(cos, sin))
    rq, rk = (attention_ops._rotate_interleaved_4d(x, cos, sin) for x in (q, k))
    assert torch.equal(out, attention_dispatch(rq, rk, v, is_causal=True, provider="_native_math"))
