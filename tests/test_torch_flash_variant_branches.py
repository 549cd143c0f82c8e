"""The branches of K5 and K7c and the segment branches of K7a and K7b: the
port's plain versions against the Pallas kernels' branches under the same
switch (`_flash_forward` and `_flash_backward` in interpret mode, Pallas tiles
of 64, each traced once with the switch set, as the JAX package reads it when
it traces, and compiled at XLA's lowest level, `jax_compiled`).

The eight (switch, branch) pairs JAX runs a variant kernel's branch for, with
`test_torch_flash_branches.py`'s inputs: cross (B, N, Sq, Skv, H) = (2, 2,
160, 224, 64) for causal with Sq < Skv and the dense mask with kv_lens, self
(2, 2, 160, 160, 64) for segment ids with -1 padding and kv_lens, with shared
(S, H) RoPE tables where the kernel takes them (JAX gates K7b off RoPE); and
K7c's causal branch once at H=128 (JAX's two-level step differs there); and
all eight pairs again at H=32, the dummy family's head dim. The
segment layout leaves rows with no live key in one of K7c's 128-key tiles:
batch 0's rows of id 1 in the second tile, and its padded rows (id -1, live
keys 148-149 only under kv_lens 150) in the first. fp32; out and LSE (dq, dk
and dv for K5, handed JAX's out and LSE) at atol 2e-5, rtol 1e-5. Every row
has a live key: the Pallas mask fold gives a row without one a value that
depends on its block size (ROADMAP.md section 3, finding 22).
"""

import contextlib
import functools
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compiled import compiled

from finetrainers_tpu_torch.ops.flash_attention import flash_backward, flash_forward, live_pairs

jax_fa = importlib.import_module("finetrainers_tpu.ops.flash_attention")
port_fa = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
B, N = 2, 2
SQ, SKV = 160, 224
LENS = np.asarray([200, 224], np.int32)
SEG_LENS = np.asarray([150, 160], np.int32)
TWOLEVEL, TWOPASS = "FINETRAINERS_FLASH_TWOLEVEL", "FINETRAINERS_FLASH_TWOPASS"
SKEW, FUSED = "FINETRAINERS_FLASH_SKEW", "FINETRAINERS_FLASH_FUSED_BWD"
# switch -> the port's plain version a CPU call takes under it
PLAIN = {TWOLEVEL: "flash_forward_two_level_reference", TWOPASS: "flash_forward_twopass_reference",
         SKEW: "flash_forward_skew_reference", FUSED: "flash_backward_fused_reference"}

CASES = {
    "two_level_causal_cross": dict(switch=TWOLEVEL, shape=(SQ, SKV), causal=True),
    "two_level_causal_self_h128": dict(switch=TWOLEVEL, shape=(SQ, SQ), causal=True, h=128),
    "two_level_segments_kv_lens_rope": dict(switch=TWOLEVEL, shape=(SQ, SQ), segments=True, lens=SEG_LENS, rope=True),
    "two_level_mask_kv_lens": dict(switch=TWOLEVEL, shape=(SQ, SKV), mask=True, lens=LENS),
    "twopass_segments_kv_lens_rope": dict(switch=TWOPASS, shape=(SQ, SQ), segments=True, lens=SEG_LENS, rope=True),
    "skew_segments_kv_lens": dict(switch=SKEW, shape=(SQ, SQ), segments=True, lens=SEG_LENS),
    "fused_bwd_causal_cross": dict(switch=FUSED, shape=(SQ, SKV), causal=True),
    "fused_bwd_segments_kv_lens_rope": dict(switch=FUSED, shape=(SQ, SQ), segments=True, lens=SEG_LENS, rope=True),
    "fused_bwd_mask_kv_lens": dict(switch=FUSED, shape=(SQ, SKV), mask=True, lens=LENS),
}
CASES.update({f"{name}_h32": dict(c, h=32) for name, c in list(CASES.items()) if "h" not in c})


@contextlib.contextmanager
def _switch(name):
    """The JAX switch `name` set while JAX traces (the cached cases outlive a test's monkeypatch)."""
    old = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


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


def _tables(s, h):
    ang = np.random.RandomState(9).uniform(0, 2 * np.pi, (s, h // 2))
    return tuple(np.repeat(f(ang), 2, -1)[None].astype(np.float32) for f in (np.cos, np.sin))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(inputs, JAX out, LSE and, for K5, its (dq, dk, dv)); each JAX call traced once, under its switch."""
    c = CASES[name]
    h = c.get("h", 64)
    sq, skv = c["shape"]
    rng = np.random.RandomState(len(name))
    q, k, v, do = (rng.randn(B, N, s, h).astype(np.float32) for s in (sq, skv, skv, sq))
    seg = _segments(sq) if c.get("segments") else None
    mask = _mask() if c.get("mask") else None
    cos, sin = _tables(sq, h) if c.get("rope") else (None, None)
    lens, causal = c.get("lens"), c.get("causal", False)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    fused = c["switch"] == FUSED

    def fwd_bwd(q, k, v, lens, seg, mask, do, cos, sin):  # the forward alone for a forward switch
        out, lse = jax_fa._flash_forward(q, k, v, lens, seg, seg, mask, h**-0.5, causal, 64, 64, cos, sin)
        if not fused:
            return out, lse, None
        return out, lse, jax_fa._flash_backward(q, k, v, lens, seg, seg, mask, out, lse, do, h**-0.5, causal, 64, 64,
                                                cos, sin)

    with _switch(c["switch"]):  # the fused switch leaves JAX's forward as it is
        out, lse, grads = compiled(fwd_bwd, j(q), j(k), j(v), j(lens), j(seg), j(mask), j(do), j(cos), j(sin))
    grads = None if grads is None else tuple(np.asarray(g) for g in grads)
    inputs = dict(q=q, k=k, v=v, do=do, lens=lens, seg=seg, mask=mask, cos=cos, sin=sin, causal=causal)
    return inputs, np.asarray(out), np.asarray(lse), grads


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _port_args(x):
    return ((_t(x["q"]), _t(x["k"]), _t(x["v"])), dict(kv_lens=_t(x["lens"]), rope_cos=_t(x["cos"]),
                                                       rope_sin=_t(x["sin"]), causal=x["causal"], q_seg=_t(x["seg"]),
                                                       kv_seg=_t(x["seg"]), mask=_t(x["mask"])))


def _count_plain(monkeypatch, name):
    """Count the calls of the port's plain version `name`."""
    calls, fn = [], getattr(port_fa, name)
    monkeypatch.setattr(port_fa, name, lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n]["switch"] != FUSED))
def test_k7_branch_plain_versions_match_the_pallas_branches(name, monkeypatch):
    x, ref_out, ref_lse, _ = _case(name)
    switch = CASES[name]["switch"]
    monkeypatch.setenv(switch, "1")
    calls = _count_plain(monkeypatch, PLAIN[switch])
    (q, k, v), kw = _port_args(x)
    out, lse = flash_forward(q, k, v, **kw)
    assert calls == [1], f"{switch} did not take {PLAIN[switch]}"
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n]["switch"] == FUSED))
def test_k5_branch_plain_versions_match_the_pallas_branches(name, monkeypatch):
    x, ref_out, ref_lse, ref_grads = _case(name)
    monkeypatch.setenv(FUSED, "1")
    calls = _count_plain(monkeypatch, PLAIN[FUSED])
    (q, k, v), kw = _port_args(x)
    grads = flash_backward(q, k, v, _t(ref_out), _t(ref_lse), _t(x["do"]), **kw)
    assert calls == [1], f"{FUSED} did not take {PLAIN[FUSED]}"
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_segment_layout_leaves_k7c_tile_rows_without_a_live_key():
    """The segment cases hold rows whose live keys all lie outside one of
    K7c's 128-key tiles (so that tile's max comes from dead scores alone),
    both before and after the tile that holds them."""
    seg = torch.from_numpy(_segments(SQ))
    live = live_pairs(B, SQ, SQ, "cpu", torch.from_numpy(SEG_LENS), q_seg=seg, kv_seg=seg)[:, 0]
    per_tile = torch.stack([live[..., :128].any(-1), live[..., 128:].any(-1)], -1)  # (B, Sq, 2)
    assert live.any(-1).all()
    assert (~per_tile[..., 0] & per_tile[..., 1]).any() and (per_tile[..., 0] & ~per_tile[..., 1]).any()
