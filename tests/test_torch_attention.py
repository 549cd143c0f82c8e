"""Attention dispatch parity: the port's providers against the JAX `_native_math`.

Same numpy inputs through the JAX package's `attention_dispatch(provider=
"_native_math")` and the port's `attention_dispatch` under `auto`, `flash` and
`_native_math`, with and without fused RoPE tables, in fp32 at atol 2e-5 and
rtol 1e-5 (fp32 sums in another order); `flex` and `flash_varlen` against
JAX's providers (the Pallas kernel's mask and segment branches in interpret
mode), `pack_sequences`, segment ids routed to `flash_varlen`, the dropout
rules and inverted-dropout semantics (torch draws, so statistics, not bits),
`is_causal` through `auto`, and ROADMAP.md section 3 finding 26 (a causal mask
read as a padding mask) in both packages. Also: every provider name the CLI
accepts is registered, and the unported ones raise NotImplementedError (for
`ring` and `ulysses`, which run their single-device branches, the
context-parallel degree that would need their other branch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.args import AttentionProviderTraining, AttentionProviderValidation
from finetrainers_tpu.ops import attention_dispatch as jax_attention_dispatch
from finetrainers_tpu.ops.attention import pack_sequences as jax_pack_sequences
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.ops import (
    attention_dispatch,
    attention_provider,
    get_active_provider,
    list_providers,
    pack_sequences,
)

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
SAGE = ("sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda", "_sage_qk_int8_pv_fp16_triton",
        "_sage_qk_int8_pv_fp8_cuda", "_sage_qk_int8_pv_fp8_cuda_sm90")
PORTED = ("auto", "flash", "tpu_flash", "flex", "flash_varlen", "_native_math", "native", *SAGE)
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


def _j(x):
    return None if x is None else jnp.asarray(x)


def _flex_mask(kind, b, sq, skv, n):
    """Every row keeps a live key (the Pallas mask fold differs on a row with
    none: ROADMAP.md section 3, finding 22)."""
    rng = np.random.RandomState(7)
    mask = rng.rand(b, 1 if kind != "head" else n, sq, skv) > 0.5
    mask[..., 0] = True
    if kind == "additive":
        return np.where(mask, 0.0, -np.inf).astype(np.float32)
    return mask


@pytest.mark.parametrize("kind", ["none", "bool", "additive", "head", "causal"])
def test_flex_matches_jax_flex(kind):
    """`flex` on the same numpy inputs as JAX's: no mask and `is_causal` (the
    kernels), a boolean or additive mask without a head axis (the mask
    branch), a head-dependent mask (JAX: XLA; the port's CPU: fp32 math)."""
    q, k, v = _qkv(2, 48, 80, 2, 64, seed=8)
    freqs = _rope(48, 2, 64) if kind == "none" else None
    if kind == "none":  # self-attention for the fused tables
        k, v = k[:, :48], v[:, :48]
    mask = None if kind in ("none", "causal") else _flex_mask(kind, 2, 48, k.shape[1], 2)
    kw = dict(provider="flex", is_causal=kind == "causal")
    ref = jax_attention_dispatch(_j(q), _j(k), _j(v), attn_mask=_j(mask),
                                 rope_freqs=None if freqs is None else tuple(map(jnp.asarray, freqs)), **kw)
    out = attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             attn_mask=None if mask is None else torch.from_numpy(mask),
                             rope_freqs=None if freqs is None else tuple(map(torch.from_numpy, freqs)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["segments", "padding_mask"])
def test_flash_varlen_matches_jax_flash_varlen(kind):
    """Packed sequences (ids 1..n, -1 padding) with shared RoPE tables through
    the segment branches, and a padding mask read as kv_lens, against JAX's
    `flash_varlen`."""
    rng = np.random.RandomState(4)
    seqs = [rng.randn(n, 2, 64).astype(np.float32) for n in (30, 18)]
    packed, ids = (np.asarray(x) for x in jax_pack_sequences(seqs, total_len=56))
    q, k, v = packed, packed[:, ::-1].copy(), rng.randn(*packed.shape).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (56, 32))
    freqs = tuple(np.repeat(f(ang), 2, -1).astype(np.float32) for f in (np.cos, np.sin))
    if kind == "segments":
        kw_j = dict(q_segment_ids=_j(ids), kv_segment_ids=_j(ids), rope_freqs=tuple(map(jnp.asarray, freqs)))
        kw_t = dict(q_segment_ids=torch.from_numpy(ids), kv_segment_ids=torch.from_numpy(ids),
                    rope_freqs=tuple(map(torch.from_numpy, freqs)))
    else:
        mask = (np.arange(56)[None, :] < np.asarray([[40]]))[:, None, None, :]
        kw_j, kw_t = dict(attn_mask=_j(mask)), dict(attn_mask=torch.from_numpy(mask))
    ref = jax_attention_dispatch(_j(q), _j(k), _j(v), provider="flash_varlen", **kw_j)
    out = attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), provider="flash_varlen",
                             **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_segment_ids_route_to_flash_varlen():
    """Any provider given segment ids runs `flash_varlen` (JAX :167-168): the
    packed call equals each sequence run alone."""
    rng = np.random.RandomState(6)
    seqs = [torch.from_numpy(rng.randn(n, 2, 64).astype(np.float32)) for n in (20, 12)]
    packed, ids = pack_sequences(seqs, total_len=40)
    out = attention_dispatch(packed, packed, packed, provider="auto", q_segment_ids=ids, kv_segment_ids=ids)
    assert torch.equal(out, attention_dispatch(packed, packed, packed, provider="flash_varlen", q_segment_ids=ids,
                                               kv_segment_ids=ids))
    for lo, seq in ((0, seqs[0]), (20, seqs[1])):
        alone = attention_dispatch(seq[None], seq[None], seq[None], provider="_native_math")
        np.testing.assert_allclose(out[:, lo:lo + len(seq)].numpy(), alone.numpy(), atol=ATOL, rtol=RTOL)


def test_pack_sequences_matches_jax():
    rng = np.random.RandomState(1)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in (5, 2, 4)]
    for total in (None, 14):
        ref_packed, ref_ids = jax_pack_sequences(seqs, total_len=total)
        packed, ids = pack_sequences(seqs, total_len=total)
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_packed))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    with pytest.raises(ValueError, match="total_len"):
        pack_sequences(seqs, total_len=3)


def test_dropout_rules_match_jax():
    """`dropout_p` without a generator raises ValueError, and beside segment ids
    NotImplementedError, in both packages."""
    q = np.zeros((1, 8, 2, 64), np.float32)
    ids = np.ones((1, 8), np.int32)
    for dispatch, arr, rng in ((jax_attention_dispatch, jnp.asarray, jax.random.PRNGKey(0)),
                               (attention_dispatch, torch.from_numpy, torch.Generator().manual_seed(0))):
        with pytest.raises(ValueError, match="dropout_rng"):
            dispatch(arr(q), arr(q), arr(q), dropout_p=0.1)
        with pytest.raises(NotImplementedError, match="segment"):
            dispatch(arr(q), arr(q), arr(q), dropout_p=0.1, dropout_rng=rng, q_segment_ids=arr(ids),
                     kv_segment_ids=arr(ids))


def test_dropout_is_inverted_dropout_on_the_probabilities():
    """With a generator `dropout_p` runs `_native_math` whatever the provider:
    with values of ones each output is sum(p * keep) / (1 - p), whose mean is 1
    and whose kept share is 1 - p; the same seed gives the same draws, and a
    rate of 0 is the identity."""
    q, k, _ = (torch.from_numpy(a) for a in _qkv(2, 64, 64, 4, 64, seed=2))
    v = torch.ones_like(k)
    out = attention_dispatch(q, k, v, dropout_p=0.25, dropout_rng=torch.Generator().manual_seed(3), provider="auto")
    again = attention_dispatch(q, k, v, dropout_p=0.25, dropout_rng=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert abs(out.mean().item() - 1.0) < 0.02
    keys = torch.ones_like(k)  # equal logits: p = 1/64 each, out = kept / (64 * 0.75)
    kept = attention_dispatch(q, keys, v, dropout_p=0.25, dropout_rng=torch.Generator().manual_seed(4))
    assert abs((kept * 48).mean().item() / 64 - 0.75) < 0.02
    plain = attention_dispatch(q, k, v, provider="_native_math")
    assert torch.equal(attention_dispatch(q, k, v, dropout_p=0.0, dropout_rng=torch.Generator(), provider="auto"),
                       attention_dispatch(q, k, v, provider="auto"))
    np.testing.assert_allclose(plain.numpy(), np.ones_like(plain.numpy()), atol=1e-6)


@pytest.mark.parametrize("provider", ["auto", "flash_varlen", "flex", "_native_math"])
def test_is_causal_matches_jax_math(provider):
    """`is_causal` with Sq < Skv (the offset diagonal): `auto` on the CPU takes
    fp32 math; `flex` and `flash_varlen` K4's causal plain versions."""
    q, k, v = _qkv(2, 40, 56, 2, 64, seed=9)
    ref = jax_attention_dispatch(_j(q), _j(k), _j(v), is_causal=True, provider="_native_math")
    out = attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), is_causal=True,
                             provider=provider)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("provider", ["flash_varlen", "sage"])
def test_finding_26_a_causal_mask_is_read_as_padding(provider):
    """ROADMAP.md section 3, finding 26 (JAX bug, reproduced): `flash_varlen`
    and `sage` turn a dense mask into kv_lens by `_kv_lens_from_padding_mask`,
    so a decoder tower's causal mask becomes "every key live" and the call
    equals unmasked attention, in both packages; the port warns once."""
    q, k, v = _qkv(1, 32, 32, 2, 64, seed=12)
    causal = np.tril(np.ones((32, 32), bool))[None, None]
    unmasked = jax_attention_dispatch(_j(q), _j(k), _j(v), provider="_native_math")
    jax_out = jax_attention_dispatch(_j(q), _j(k), _j(v), attn_mask=_j(causal), provider=provider)
    port_out = attention_dispatch(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  attn_mask=torch.from_numpy(causal), provider=provider)
    tol = dict(atol=ATOL, rtol=RTOL) if provider == "flash_varlen" else dict(atol=0.05, rtol=0.05)  # sage: int8
    np.testing.assert_allclose(np.asarray(jax_out), np.asarray(unmasked), **tol)
    np.testing.assert_allclose(port_out.numpy(), np.asarray(unmasked), **tol)
    causal_ref = jax_attention_dispatch(_j(q), _j(k), _j(v), attn_mask=_j(causal), provider="_native_math")
    assert np.abs(np.asarray(causal_ref) - np.asarray(unmasked)).max() > 0.1
