"""Attention dispatch parity: the port's providers against the JAX `_native_math`.

Same numpy inputs through the JAX package's `attention_dispatch(provider=
"_native_math")` and the port's `attention_dispatch` under `auto`, `flash` and
`_native_math`, with and without fused RoPE tables, in fp32 at atol 2e-5 and
rtol 1e-5 (fp32 sums in another order). Also: every provider name the CLI
accepts is registered, and the unported ones raise NotImplementedError (for
`ring` and `ulysses`, which run their single-device branches, the
context-parallel degree that would need their other branch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.args import AttentionProviderTraining, AttentionProviderValidation
from finetrainers_tpu.ops import attention_dispatch as jax_attention_dispatch
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.ops import attention_dispatch, attention_provider, get_active_provider, list_providers

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
SAGE = ("sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda", "_sage_qk_int8_pv_fp16_triton",
        "_sage_qk_int8_pv_fp8_cuda", "_sage_qk_int8_pv_fp8_cuda_sm90")
PORTED = ("auto", "flash", "tpu_flash", "_native_math", "native", *SAGE)
UNPORTED = sorted(set(AttentionProviderValidation) - set(PORTED))
# Their single-device branches are ported; their context-parallel branches are not.
CP_PROVIDERS = ("ring", "ulysses")


def _qkv(b, sq, skv, n, h, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, n, h).astype(np.float32) for s in (sq, skv, skv))


def _rope(s, n, h, seed=1):
    ang = np.random.RandomState(seed).uniform(0, 2 * np.pi, (s, n * h // 2))
    return np.repeat(np.cos(ang), 2, -1).astype(np.float32), np.repeat(np.sin(ang), 2, -1).astype(np.float32)


def _both(fn, *arrays):
    return fn(*(None if a is None else torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("provider", ["auto", "flash", "_native_math"])
@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_self_attention_matches_jax_math(provider, rope):
    q, k, v = _qkv(2, 50, 50, 2, 64)
    freqs = _rope(50, 2, 64) if rope else None
    ref = jax_attention_dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), provider="_native_math",
                                 rope_freqs=None if freqs is None else tuple(map(jnp.asarray, freqs)))
    out = attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), provider=provider,
                             rope_freqs=None if freqs is None else tuple(map(torch.from_numpy, freqs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("provider", ["auto", "flash", "_native_math"])
def test_cross_attention_kv_lens_matches_jax_math(provider):
    q, k, v = _qkv(2, 40, 24, 2, 64, seed=3)
    lens = np.asarray([24, 5], np.int32)
    ref = jax_attention_dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=jnp.asarray(lens),
                                 provider="_native_math")
    out = attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             kv_lens=torch.from_numpy(lens), provider=provider)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_native_sdpa_baseline_matches_math():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 24, 2, 64, seed=4))
    lens = torch.tensor([24, 9], dtype=torch.int32)
    ref = attention_dispatch(q, k, v, kv_lens=lens, provider="_native_math")
    out = attention_dispatch(q, k, v, kv_lens=lens, provider="native")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


def test_auto_routes_masks_to_math():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 2, 64, seed=5))
    mask = torch.ones(1, 1, 16, 16, dtype=torch.bool).tril()
    ref = attention_dispatch(q, k, v, attn_mask=mask, provider="_native_math")
    np.testing.assert_allclose(attention_dispatch(q, k, v, attn_mask=mask, provider="auto").numpy(), ref.numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention_dispatch(q, k, v, attn_mask=mask, provider="flash")


def test_every_cli_provider_is_registered():
    assert set(AttentionProviderTraining) <= set(AttentionProviderValidation)
    assert set(AttentionProviderValidation) <= set(list_providers())


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_provider_raises(name):
    if name in CP_PROVIDERS:
        # Ported outside a context-parallel region (tests/test_torch_ring_ulysses.py); the degree that would
        # open one is what raises.
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            BaseArgs(cp_degree=2, attn_provider_training=[f"transformer:{name}"]).check_ported()
        return
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention_dispatch(q, q, q, provider=name)


def test_attention_provider_context_switches_and_restores():
    before = get_active_provider()
    with attention_provider("_native_math"):
        assert get_active_provider() == "_native_math"
    assert get_active_provider() == before
    with pytest.raises(ValueError, match="Unknown attention provider"):
        with attention_provider("no_such_provider"):
            pass
