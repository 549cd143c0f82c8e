"""K1's dense-mask branch: its plain version against the Pallas kernel's
`mask_ref` branch (`_flash_forward(..., attn_mask=...)`, the `flex` block map
skipping all-zero tiles) in interpret mode, GQA against JAX's
`_math_attention`, the tile lists at K1's own tiles, and the routing.

One shape for every mask, (B, N, Sq, Skv, H) = (2, 2, 160, 224, 64) with
Pallas tiles of 64 (so the JAX side is compiled once): causal (offset by
Skv - Sq), causal and padding (valid keys [100, 224]), and a block-sparse mask
with a key tile off for every row, an empty row and ragged last tiles. fp32,
rows with a live key compared at atol 2e-5, rtol 1e-5. A row with no live
key: the port gives out 0 and an LSE of -1e30*ln2 (K1's kv_lens rule); the
Pallas branch's additive fold gives a value there that depends on its block
size, a deliberate difference (ROADMAP.md section 3, finding 22).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.ops.attention import _math_attention as jax_math_attention
from finetrainers_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from finetrainers_tpu_torch.ops import attention as attention_ops
from finetrainers_tpu_torch.ops.flash_attention import (
    _MASK_FULL_TILE,
    flash_attention,
    flash_attention_masked_reference,
    flash_forward_masked,
    k1_block_m,
    mask_tiles,
)

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
B, N, SQ, SKV, H = 2, 2, 160, 224, 64
EMPTY_LSE = np.float32(-1e30 * np.log(2.0))


def _mask(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    causal = np.tril(np.ones((SQ, SKV), bool), SKV - SQ)[None].repeat(B, 0)
    if kind == "causal":
        return causal
    if kind == "causal_padding":
        return causal & (np.arange(SKV)[None, :] < np.asarray([100, 224])[:, None])[:, None]
    blocks = rng.rand(B, -(-SQ // 32), -(-SKV // 32)) > 0.3
    mask = blocks.repeat(32, 1).repeat(32, 2)[:, :SQ, :SKV] & (rng.rand(B, SQ, SKV) > 0.25)
    mask[:, :, 64:128] = False  # a Pallas key tile and half of K1's first key tile off for every row
    mask[1, :, 128:] = False  # batch 1: K1's ragged last key tile all zero, skipped
    mask[0, 7] = False  # a row with no live key
    return mask


def _inputs():
    rng = np.random.RandomState(11)
    return tuple(rng.randn(B, N, s, H).astype(np.float32) for s in (SQ, SKV, SKV))


@functools.lru_cache(maxsize=None)
def _jax(kind):
    q, k, v = _inputs()
    run = jax.jit(lambda q, k, v, mask: jax_flash_forward(q, k, v, None, None, None, mask, H**-0.5, False, 64, 64))
    out, lse = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_mask(kind)))
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("kind", ["causal", "causal_padding", "block_sparse"])
def test_masked_plain_version_matches_the_pallas_branch(kind):
    q, k, v = (torch.from_numpy(x) for x in _inputs())
    mask = _mask(kind)
    ref_out, ref_lse = _jax(kind)
    out, lse = flash_attention_masked_reference(q, k, v, torch.from_numpy(mask))
    live = mask.any(-1)  # (B, Sq)
    rows = np.broadcast_to(live[:, None, :], lse.shape)
    np.testing.assert_allclose(out.numpy()[rows], ref_out[rows], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy()[rows], ref_lse[rows], atol=ATOL, rtol=RTOL)
    wrapped, wrapped_lse = flash_forward_masked(q, k, v, torch.from_numpy(mask))  # the CPU takes the plain version
    assert torch.equal(wrapped, out) and torch.equal(wrapped_lse, lse)
    if kind == "block_sparse":  # the empty row: 0 and -1e30*ln2 here; block-size dependent in the Pallas fold
        assert not live.all() and not out.numpy()[~rows].any() and (lse.numpy()[~rows] == EMPTY_LSE).all()
        assert np.isfinite(ref_out[~rows]).all() and np.abs(ref_out[~rows]).max() > 0


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal_padding"])
@pytest.mark.parametrize("kv_heads", [1, 2])
def test_gqa_repeats_the_kv_heads_as_jax(kv_heads, masked):
    """`flash_attention` (BTNH) with Nkv of N=4 heads against JAX's
    `_math_attention`, which repeats them too; under a mask on the rows with a live key."""
    rng = np.random.RandomState(kv_heads)
    q = rng.randn(B, SQ, 4, H).astype(np.float32)
    k, v = (rng.randn(B, SKV, kv_heads, H).astype(np.float32) for _ in range(2))
    mask = _mask("causal_padding") if masked else None
    ref = np.asarray(jax_math_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        None if mask is None else jnp.asarray(mask)[:, None], 0.0, False, None, None))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          attn_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_mask_tiles_list_the_live_tiles_at_k1_tiles(head_dim):
    mask = _mask("block_sparse")
    padded, tiles, counts = mask_tiles(torch.from_numpy(mask), head_dim)
    bm = k1_block_m(head_dim)
    nq, nk = -(-SQ // bm), -(-SKV // 128)
    assert padded.shape == (B, nq * bm, nk * 128) and padded.dtype == torch.uint8
    assert torch.equal(padded[:, :SQ, :SKV].bool(), torch.from_numpy(mask)) and not padded[:, SQ:].any()
    blocks = np.zeros((B, nq * bm, nk * 128), bool)
    blocks[:, :SQ, :SKV] = mask
    blocks = blocks.reshape(B, nq, bm, nk, 128)
    for b in range(B):
        for qt in range(nq):
            live = [j for j in range(nk) if blocks[b, qt, :, j].any()]
            entries = tiles[b, qt, :counts[b, qt]].tolist()
            assert [e & (_MASK_FULL_TILE - 1) for e in entries] == live
            assert [bool(e & _MASK_FULL_TILE) for e in entries] == [bool(blocks[b, qt, :, j].all()) for j in live]
    assert (counts[1] == 1).all() and (counts[0] == nk).all()  # batch 1 skips its all-zero last key tile


def test_k1_takes_masks_and_gqa_on_the_card():
    """On the card (meta tensors stand in): a boolean mask without a head axis
    at head dim 64 or 128 (with a causal flag folded into it), a causal call at
    64 or 128, and GQA, go to K1; head-dependent or additive masks and head dim
    32 under a mask or a causal flag do not. On the CPU masks, causal calls
    and GQA go to fp32 math."""
    q = torch.empty(2, 77, 4, 128, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 77, 2, 128, dtype=torch.bfloat16, device="meta")
    mask = torch.empty(2, 1, 77, 77, dtype=torch.bool, device="meta")
    takes = attention_ops._k1_takes
    assert takes(q, kv, None, False) and takes(q, kv, mask, False) and takes(q, q, mask[0, 0], False)
    assert takes(q, kv, mask, True) and takes(q, kv, None, True)
    assert not takes(q, kv, mask.expand(2, 4, 77, 77), False)  # depends on the head
    assert not takes(q, kv, torch.empty(2, 1, 77, 77, device="meta"), False)  # additive
    assert not takes(q[..., :32], kv[..., :32], mask, False) and takes(q[..., :32], kv[..., :32], None, False)
    assert not takes(q[..., :32], kv[..., :32], None, True)
    cpu = torch.zeros(2, 77, 4, 64)
    assert not takes(cpu, cpu[:, :, :2], None, False) and not takes(cpu, cpu, torch.ones(77, 77, dtype=torch.bool),
                                                                    False)
    assert not takes(cpu, cpu, None, True)


def test_masked_flash_attention_is_forward_only():
    """No longer forward only: a masked call's gradient runs K2/K3's mask
    branches (their plain versions here) and equals autograd through plain
    fp32 attention under the same mask, a row with no live key getting none."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, s, 2, 64).astype(np.float32)).requires_grad_(True)
               for s in (24, 40, 40))
    mask = torch.from_numpy(rng.rand(1, 24, 40) > 0.5)
    mask[0, 3] = False
    out = flash_attention(q, k, v, attn_mask=mask)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    live = mask.any(-1)[:, :, None, None]
    # Plain math gives the empty row NaN: it attends every key there and is cut out of the loss.
    ref = attention_ops._math_attention(q, k, v, (mask | ~live[..., 0])[:, None], False, None, None) * live
    ref_grads = torch.autograd.grad((ref * ref).sum(), (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=ATOL, rtol=RTOL)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    assert not grads[0][0, 3].any()
