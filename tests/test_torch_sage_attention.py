"""K6 parity: the port's plain int8 SageAttention against the JAX package's.

The JAX side runs the Pallas `_sage_fwd_kernel` in interpret mode (as
`tests/ops/test_attention.py` runs it on the CPU; jitted and compiled at XLA's
lowest level, `jax_compiled`); the port runs K6's plain version
(`sage_attention_reference`, which a CPU tensor takes), at head dims 32 (the
dummy family's), 64 and 128. Inputs are seeded numpy, k with a channel offset
that smooth-K removes.

Tolerances:
  - fp32: atol 1e-5. The codes are the same (the same fp32 divisions and
    round-half-to-even); only the order of fp32 sums differs.
  - bf16: atol 1e-2 with rtol 1e-2, about two bf16 units in the last place:
    both compute in fp32 and round the output to bf16 once, and a sum in
    another order can move a value across a rounding boundary.
  - codes: q codes and scales equal; the smoothed k's mean is summed in
    another order, so at most 0.1% of k codes may differ, by one (an exact tie
    of the rounding); k scales within rtol 1e-6.
  - dispatch: the sage names against JAX's `attention_dispatch` with shared
    (S, H) RoPE tables (both rotate q and k in fp32 first): atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compiled import compiled

from finetrainers_tpu.ops import attention_dispatch as jax_attention_dispatch
from finetrainers_tpu.ops.sage_attention import _quantize_per_token as jax_quantize
from finetrainers_tpu.ops.sage_attention import sage_attention as jax_sage_attention
from finetrainers_tpu_torch.ops import attention_dispatch, list_providers
from finetrainers_tpu_torch.ops.sage_attention import sage_attention, sage_quantize, sage_forward

torch.set_num_threads(1)

SAGE_NAMES = ("sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda", "_sage_qk_int8_pv_fp16_triton",
              "_sage_qk_int8_pv_fp8_cuda", "_sage_qk_int8_pv_fp8_cuda_sm90")
TOLS = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=1e-2, rtol=1e-2)}


def _qkv(b, sq, skv, n, h, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, n, h).astype(np.float32) for s in (sq, skv, skv))
    return q, k + 1.5 * rng.randn(1, 1, n, h).astype(np.float32), v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_plain_k6_matches_jax_pallas(head_dim, dtype):
    """Self-attention shapes off every block boundary, kv_lens with an empty row."""
    q, k, v = _qkv(3, 70, 70, 2, head_dim)
    lens = np.asarray([70, 33, 0], np.int32)
    ref = compiled(lambda q, k, v, lens: jax_sage_attention(q, k, v, kv_lens=lens),
                   *(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(lens))
    tdtype = getattr(torch, dtype)
    before = sage_forward.launches
    out = sage_attention(*(torch.from_numpy(x).to(tdtype) for x in (q, k, v)), kv_lens=torch.from_numpy(lens))
    assert sage_forward.launches == before  # a CPU tensor takes the plain version, never a kernel
    assert out.dtype == tdtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **TOLS[dtype])
    assert not out[2].any()  # no valid key: exact zeros


def test_plain_k6_matches_jax_pallas_cross_attention_gqa():
    """Cross-attention over 40 padded text keys with 2 KV heads for 4 q heads."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 33, 4, 64).astype(np.float32)
    k, v = (rng.randn(2, 40, 2, 64).astype(np.float32) for _ in range(2))
    lens = np.asarray([9, 40], np.int32)
    ref = compiled(lambda q, k, v, lens: jax_sage_attention(q, k, v, kv_lens=lens),
                   jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    out = sage_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOLS["float32"])


def test_codes_and_scales_match_jax():
    q, k, _ = _qkv(2, 64, 64, 2, 128, seed=1)
    lens = np.asarray([64, 21], np.int32)
    q_codes, k_codes, q_scales, k_scales = sage_quantize(torch.from_numpy(q), torch.from_numpy(k),
                                                         torch.from_numpy(lens))
    # JAX's pre-pass (`_sage_impl` :112-121) on BNSH arrays.
    qb, kb = jnp.swapaxes(jnp.asarray(q), 1, 2), jnp.swapaxes(jnp.asarray(k), 1, 2)
    valid = jnp.arange(64)[None, None, :, None] < jnp.asarray(lens)[:, None, None, None]
    denom = jnp.maximum(jnp.asarray(lens).astype(jnp.float32), 1.0)[:, None, None, None]
    k_mean = jnp.sum(jnp.where(valid, kb, 0.0), axis=2, keepdims=True) / denom
    ref_q, ref_qs = jax_quantize(qb)
    ref_k, ref_ks = jax_quantize(kb - k_mean)
    np.testing.assert_array_equal(q_codes.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(q_scales.numpy(), np.asarray(ref_qs))
    diff = np.abs(k_codes.numpy().astype(np.int32) - np.asarray(ref_k).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(k_scales.numpy(), np.asarray(ref_ks), rtol=1e-6, atol=0)


def test_quantization_of_zero_rows_and_ties():
    """absmax 0 gives scale 1 and codes 0; halves round to even."""
    x = torch.zeros(1, 2, 1, 64)
    x[0, 1, 0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])
    codes, _, scales, _ = sage_quantize(x, x, torch.tensor([2]))
    assert scales[0, 0, 0] == 1.0 and not codes[0, 0, 0].any()
    assert codes[0, 0, 1, :4].tolist() == [127, 0, 2, -2]


@pytest.mark.parametrize("name", SAGE_NAMES)
def test_dispatch_matches_jax(name):
    """Every sage name, with shared (S, H) RoPE tables, a padding mask turned
    into kv_lens, against JAX's dispatch under the same name."""
    assert name in list_providers()
    q, k, v = _qkv(2, 48, 48, 2, 64, seed=2)
    ang = np.random.RandomState(3).uniform(0, 2 * np.pi, (48, 32))
    cos, sin = (np.repeat(f(ang), 2, -1).astype(np.float32) for f in (np.cos, np.sin))
    mask = np.arange(48)[None, None, None, :] < np.asarray([48, 17])[:, None, None, None]
    ref = compiled(lambda q, k, v, mask, cos, sin: jax_attention_dispatch(q, k, v, attn_mask=mask, provider=name,
                                                                           rope_freqs=(cos, sin)),
                   jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.asarray(cos),
                   jnp.asarray(sin))
    out = attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             attn_mask=torch.from_numpy(mask), provider=name,
                             rope_freqs=(torch.from_numpy(cos), torch.from_numpy(sin)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_smooth_k_shift_invariance():
    """A constant added to every key leaves the output unchanged (softmax is
    shift invariant and smooth-K removes the mean before quantization): only
    fp32 rounding of the mean can move a code, so atol 1e-4."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 64, 2, 64, seed=4))
    out = sage_attention(q, k, v)
    shifted = sage_attention(q, k + 3.0, v)
    np.testing.assert_allclose(shifted.numpy(), out.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["causal", "dense_mask"])
def test_sage_takes_plain_math_on_cpu_for_what_k6_does_not_take(kind):
    """A causal call, or a dense mask beside kv_lens, takes `_native_math` on a
    CPU tensor (on the card it raises: tests/test_torch_kernels_gpu.py)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 24, 24, 2, 64, seed=6))
    kw = dict(is_causal=True)
    if kind == "dense_mask":
        kw = dict(attn_mask=torch.rand(2, 1, 24, 24, generator=torch.Generator().manual_seed(0)) > 0.3,
                  kv_lens=torch.tensor([24, 20]))
    out = attention_dispatch(q, k, v, provider="sage", **kw)
    ref = attention_dispatch(q, k, v, provider="_native_math", **kw)
    assert torch.equal(out, ref)
