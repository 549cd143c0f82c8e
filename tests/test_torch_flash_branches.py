"""The causal, segment-id and dense-mask branches of K1, K2 and K3: their plain
versions against the Pallas kernels' branches (`_flash_forward` and
`_flash_backward` in interpret mode, Pallas tiles of 64), and the routing of
branch calls under the kernel switches against JAX's gates.

Two shapes, so the JAX side compiles twice per branch: cross (B, N, Sq, Skv,
H) = (2, 2, 160, 224, 64) for causal with Sq < Skv and the dense mask with
kv_lens, self (2, 2, 160, 160, 64) for causal with Sq = Skv and segment ids
with -1 padding, kv_lens and shared (S, H) RoPE tables. fp32; out, LSE, dq, dk
and dv at atol 2e-5, rtol 1e-5. The port's backward is handed JAX's out and
LSE. Every row has a live key: the Pallas mask fold gives a row without one a
value that depends on its block size (ROADMAP.md section 3, finding 22).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu_torch.ops.flash_attention import (
    branch_of,
    flash_backward,
    flash_forward,
    forward_variant,
    live_pairs,
    mask_tiles_bwd,
    segment_blocks,
)

jax_fa = importlib.import_module("finetrainers_tpu.ops.flash_attention")
port_fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
B, N, H = 2, 2, 64
SQ, SKV = 160, 224
LENS = np.asarray([200, 224], np.int32)


def _qkv(sq, skv, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, N, s, H).astype(np.float32) for s in (sq, skv, skv, sq))


def _segments(s):
    """Packed ids: batch 0 three sequences and 12 padded slots (-1), batch 1 two."""
    q = np.full((B, s), -1, np.int32)
    q[0, :60], q[0, 60:100], q[0, 100:s - 12] = 1, 2, 3
    q[1, :90], q[1, 90:] = 1, 2
    return q


def _mask():
    rng = np.random.RandomState(5)
    mask = rng.rand(B, SQ, SKV) > 0.4
    mask[:, :, 64:128] = False  # a Pallas key tile dead for every row
    mask[1, 100:] &= np.arange(SKV) < 150  # a ragged block
    mask[:, :, 0] = True  # every row keeps a live key (kv_lens cuts only past 200)
    return mask


def _tables(s):
    ang = np.random.RandomState(9).uniform(0, 2 * np.pi, (s, H // 2))
    return tuple(np.repeat(f(ang), 2, -1)[None].astype(np.float32) for f in (np.cos, np.sin))


CASES = {
    "causal_cross": dict(shape=(SQ, SKV), causal=True),
    "causal_self": dict(shape=(SQ, SQ), causal=True),
    "segments_kv_lens_rope": dict(shape=(SQ, SQ), segments=True, lens=np.asarray([150, 160], np.int32), rope=True),
    "mask_kv_lens": dict(shape=(SQ, SKV), mask=True, lens=LENS),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    c = CASES[name]
    sq, skv = c["shape"]
    q, k, v, do = _qkv(sq, skv, seed=len(name))
    seg = _segments(sq) if c.get("segments") else None
    mask = _mask() if c.get("mask") else None
    cos, sin = _tables(sq) if c.get("rope") else (None, None)
    lens = c.get("lens")
    causal = c.get("causal", False)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    fwd = jax.jit(lambda q, k, v, lens, seg, mask, cos, sin: jax_fa._flash_forward(
        q, k, v, lens, seg, seg, mask, H**-0.5, causal, 64, 64, cos, sin))
    out, lse = fwd(j(q), j(k), j(v), j(lens), j(seg), j(mask), j(cos), j(sin))
    bwd = jax.jit(lambda q, k, v, lens, seg, mask, out, lse, do, cos, sin: jax_fa._flash_backward(
        q, k, v, lens, seg, seg, mask, out, lse, do, H**-0.5, causal, 64, 64, cos, sin))
    grads = bwd(j(q), j(k), j(v), j(lens), j(seg), j(mask), out, lse, j(do), j(cos), j(sin))
    inputs = dict(q=q, k=k, v=v, do=do, lens=lens, seg=seg, mask=mask, cos=cos, sin=sin, causal=causal)
    return inputs, np.asarray(out), np.asarray(lse), tuple(np.asarray(g) for g in grads)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_plain_versions_match_the_pallas_branches(name):
    x, ref_out, ref_lse, _ = _case(name)
    out, lse = flash_forward(_t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["lens"]), _t(x["cos"]), _t(x["sin"]), None,
                             x["causal"], _t(x["seg"]), _t(x["seg"]), _t(x["mask"]))
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_plain_versions_match_the_pallas_branches(name):
    x, ref_out, ref_lse, (ref_dq, ref_dk, ref_dv) = _case(name)
    dq, dk, dv = flash_backward(_t(x["q"]), _t(x["k"]), _t(x["v"]), _t(ref_out), _t(ref_lse), _t(x["do"]),
                                _t(x["lens"]), _t(x["cos"]), _t(x["sin"]), None, None, x["causal"], _t(x["seg"]),
                                _t(x["seg"]), _t(x["mask"]))
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_causal_offset_rows_without_a_key_give_zero():
    """Sq > Skv: the first Sq - Skv rows see no key; out 0, LSE -1e30*ln2, no gradient."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(SKV, SQ, seed=3))
    q.requires_grad_(True)
    out, lse = flash_forward(q, k, v, causal=True)
    dead = SKV - SQ
    assert not out[:, :, :dead].any() and (lse[:, :, :dead] == np.float32(-1e30 * np.log(2.0))).all()
    dq, dk, dv = flash_backward(q, k, v, out, lse, do, causal=True)
    assert not dq[:, :, :dead].any() and dq[:, :, dead:].abs().max() > 0


def test_segment_blocks_are_exact_for_any_id_layout():
    """A block is listed live wherever some pair in it is live (so a skip never
    drops one), at K1's, K2's and K3's tiles, with ids in no order."""
    rng = np.random.RandomState(2)
    q_seg, kv_seg = (torch.from_numpy(rng.randint(-1, 4, (B, s)).astype(np.int32)) for s in (SQ, SKV))
    lens = torch.from_numpy(LENS)
    pairs = live_pairs(B, SQ, SKV, "cpu", lens, q_seg=q_seg, kv_seg=kv_seg)[:, 0]
    for block_q in (64, 128, 192):
        live, full = segment_blocks(q_seg, kv_seg, lens, block_q)
        padded = torch.zeros(B, live.shape[1] * block_q, live.shape[2] * 128, dtype=torch.bool)
        padded[:, :SQ, :SKV] = pairs
        blocks = padded.view(B, live.shape[1], block_q, live.shape[2], 128)
        assert not (blocks.any(dim=(2, 4)) & ~live).any()
        assert not (full & ~live).any()


def test_backward_mask_lists_at_k2_and_k3_tiles():
    mask = torch.from_numpy(_mask())
    (mask_t, k2_tiles, k2_counts), (padded, k3_tiles, k3_counts) = mask_tiles_bwd(mask)
    assert torch.equal(mask_t[:, :SKV, :SQ].bool(), mask.transpose(1, 2)) and not mask_t[:, SKV:].any()
    assert torch.equal(padded[:, :SQ, :SKV].bool(), mask)
    for b in range(B):
        for kt in range(k2_tiles.shape[1]):
            live = [qt for qt in range(k2_tiles.shape[2])
                    if mask_t[b, kt * 128:(kt + 1) * 128, qt * 64:(qt + 1) * 64].any()]
            assert [e & 0xFFFF for e in k2_tiles[b, kt, :k2_counts[b, kt]].tolist()] == live
        for qt in range(k3_tiles.shape[1]):
            live = [kt for kt in range(k3_tiles.shape[2])
                    if padded[b, qt * 128:(qt + 1) * 128, kt * 128:(kt + 1) * 128].any()]
            assert [e & 0xFFFF for e in k3_tiles[b, qt, :k3_counts[b, qt]].tolist()] == live


_SWITCHES = ("FINETRAINERS_FLASH_SKEW", "FINETRAINERS_FLASH_TWOPASS", "FINETRAINERS_FLASH_TWOLEVEL",
             "FINETRAINERS_FLASH_FUSED_BWD")
_FWD_NAMES = {"_fwd_kernel": None, "_fwd_kernel_twopass": "flash_forward_twopass",
              "_fwd_kernel_skew": "flash_forward_skew"}


class _Picked(Exception):
    pass


def _jax_kernel(monkeypatch, fn, *args):
    """The kernel JAX's `fn` hands its first `pallas_call`, caught before it runs."""
    def pallas_call(kernel, *a, **kw):
        raise _Picked(kernel)

    monkeypatch.setattr(jax_fa.pl, "pallas_call", pallas_call)
    try:
        fn(*args)
    except _Picked as picked:
        return picked.args[0]
    raise AssertionError("no pallas_call")


@pytest.mark.parametrize("branch", ["causal", "segment", "mask"])
@pytest.mark.parametrize("switch", _SWITCHES)
@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
def test_branch_routing_follows_jax_gates(monkeypatch, switch, branch, rope):
    """Under each switch, a branch call goes where JAX's gates send it: to K1's
    branch where JAX runs `_fwd_kernel` or the split backward (the port
    launches K1-K3's branch), and where JAX runs an unported K5/K7 branch the
    port raises naming ROADMAP.md queue 2 item 5."""
    monkeypatch.setenv(switch, "1")
    s = 128
    q = jnp.zeros((1, 1, s, H), jnp.float32)
    seg = jnp.ones((1, s), jnp.int32) if branch == "segment" else None
    mask = jnp.ones((1, s, s), bool) if branch == "mask" else None
    cos = sin = jnp.ones((1, s, H), jnp.float32) if rope else None
    causal = branch == "causal"
    kernel = _jax_kernel(monkeypatch, jax_fa._flash_forward, q, q, q, None, seg, seg, mask, 0.125, causal, 64, 64,
                         cos, sin)
    jax_pick = "flash_forward_two_level" if kernel.keywords.get("two_level") else _FWD_NAMES[kernel.func.__name__]
    variant = forward_variant(rope, causal, branch == "mask")
    assert (None if variant is None else variant.__name__) == jax_pick
    assert branch_of(causal, seg, mask) == branch
    tq = torch.zeros(1, 1, s, H)
    tseg = torch.ones(1, s, dtype=torch.int32) if branch == "segment" else None
    tmask = torch.ones(1, s, s, dtype=torch.bool) if branch == "mask" else None
    tcos = torch.ones(1, s, H) if rope else None
    if jax_pick is not None:
        with pytest.raises(NotImplementedError, match="queue 2 item 5"):
            flash_forward(tq, tq, tq, None, tcos, tcos, None, causal, tseg, tseg, tmask)
    else:
        flash_forward(tq, tq, tq, None, tcos, tcos, None, causal, tseg, tseg, tmask)
    kernel = _jax_kernel(monkeypatch, jax_fa._flash_backward, q, q, q, None, seg, seg, mask, q, q[..., 0], q, 0.125,
                         causal, 64, 64, cos, sin)
    fused = kernel.func.__name__ == "_bwd_fused_kernel"
    assert fused == (switch == "FINETRAINERS_FLASH_FUSED_BWD")
    if fused:
        with pytest.raises(NotImplementedError, match="queue 2 item 5"):
            flash_backward(tq, tq, tq, tq, tq[..., 0], tq, None, tcos, tcos, None, None, causal, tseg, tseg, tmask)
    else:
        flash_backward(tq, tq, tq, tq, tq[..., 0], tq, None, tcos, tcos, None, None, causal, tseg, tseg, tmask)


def test_k1_k2_k3_branches_refuse_head_dim_32_on_the_card():
    """The branches have no H=32 instance: meta tensors stand in for the card."""
    q = torch.empty(1, 2, 64, 32, dtype=torch.bfloat16, device="meta")
    for kwargs in (dict(causal=True), dict(q_seg=torch.empty(1, 64, dtype=torch.int32, device="meta"),
                                            kv_seg=torch.empty(1, 64, dtype=torch.int32, device="meta"))):
        with pytest.raises(ValueError, match="queue 2 item 5"):
            flash_forward(q, q, q, **kwargs)
    assert port_fa.BRANCH_HEAD_DIMS == (64, 128)
