"""K7a/b/c parity: the port's plain versions of the forward variants against the
JAX Pallas kernels under the same switch.

FINETRAINERS_FLASH_TWOPASS, _SKEW and _TWOLEVEL make the JAX `flash_attention`
run `_fwd_kernel_twopass`, `_fwd_kernel_skew` or `_fwd_kernel`'s `two_level`
branch in interpret mode on the CPU (traced afresh in each test with the
switch set by `monkeypatch`, and compiled at XLA's lowest level,
`jax_compiled`); under the same switch the port's `flash_attention` takes
`flash_forward_twopass_reference`, `..._skew_reference` or
`..._two_level_reference` for CPU tensors. Cases as the JAX package's
`TestForwardKernelVariants`: plain, `kv_lens`, H=128, H=128 with `kv_lens`,
H=32 (the dummy family's) with `kv_lens` and an empty row,
over 150 keys (two of K7a's and K7c's 128-key tiles and three of K7b's 64-key
score tiles, the last ragged; 32-key blocks on the JAX side); then RoPE with
per-head and shared tables for the two-pass and two-level kernels (at H 32 too), the skew
gate, and each variant over several of its tiles (ragged last tiles,
`kv_lens` inside a tile and at a tile boundary with an empty row, per-head
tables, cross-attention) against JAX at 32- and 128-key blocks. fp32, compared at atol 2e-5, rtol 1e-5, as K1 (the
variants reorder fp32 arithmetic: block-local maxima, no rescale, another
tiling).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_compiled import compiled
from test_torch_flash_attention import _j, _ltx_tables, _shared_tables, _t

from finetrainers_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from finetrainers_tpu_torch.ops.flash_attention import flash_attention, forward_variant

torch.set_num_threads(1)
port_flash_ops = importlib.import_module("finetrainers_tpu_torch.ops.flash_attention")

ATOL, RTOL = 2e-5, 1e-5
# switch -> the plain version the port's CPU calls take under it
VARIANTS = {
    "FINETRAINERS_FLASH_SKEW": "flash_forward_skew_reference",
    "FINETRAINERS_FLASH_TWOLEVEL": "flash_forward_two_level_reference",
    "FINETRAINERS_FLASH_TWOPASS": "flash_forward_twopass_reference",
}


@pytest.fixture
def switch(monkeypatch):
    """Set one switch (clearing the others) and count the calls of the plain
    version it picks."""
    calls = []

    def set_switch(env):
        for name in VARIANTS:
            monkeypatch.delenv(name, raising=False)
        if env is not None:
            monkeypatch.setenv(env, "1")
            plain = getattr(port_flash_ops, VARIANTS[env])
            monkeypatch.setattr(port_flash_ops, VARIANTS[env], lambda *a, **kw: calls.append(1) or plain(*a, **kw))
        return calls

    return set_switch


def _run_both(h=64, kv_lens=None, rope=None, s=150, jax_block_kv=32, b=2, s_kv=None, with_jax=True):
    """(port, JAX) outputs for one seeded BTNH call: `s` query rows and `s_kv`
    keys (`s` unless given); without `with_jax`, the port's alone (and None)."""
    rng = np.random.RandomState(7)
    n = 3
    q, k, v = (rng.randn(b, length, n, h).astype(np.float32) for length in (s, s_kv or s, s_kv or s))
    cos = sin = None
    if rope == "per_head":
        cos, sin = _ltx_tables(n, h, (2, 3, s // 6))
    elif rope == "shared":
        cos, sin = _shared_tables(s, h, rng)
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int32)
    out = flash_attention(_t(q), _t(k), _t(v), kv_lens=_t(lens), rope_cos=_t(cos), rope_sin=_t(sin))
    if not with_jax:
        return out.numpy(), None
    ref = compiled(lambda q, k, v, lens, cos, sin: jax_flash_attention(
        q, k, v, kv_lens=lens, rope_cos=cos, rope_sin=sin, block_q=32, block_kv=jax_block_kv),
        _j(q), _j(k), _j(v), _j(lens), _j(cos), _j(sin))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("env", sorted(VARIANTS))
@pytest.mark.parametrize("kw", [{}, {"kv_lens": [133, 17]}, {"h": 128}, {"h": 128, "kv_lens": [133, 0]},
                                {"h": 32, "kv_lens": [150, 0]}],
                         ids=["plain", "kv_lens", "h128", "h128_kv_lens", "h32_kv_lens"])
def test_variant_matches_jax(env, kw, switch):
    calls = switch(env)
    out, ref = _run_both(**kw)
    assert calls == [1], f"{env} did not take {VARIANTS[env]}"
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    if kw.get("kv_lens") and 0 in kw["kv_lens"]:
        assert not out[kw["kv_lens"].index(0)].any()


@pytest.mark.parametrize("env", ["FINETRAINERS_FLASH_TWOPASS", "FINETRAINERS_FLASH_TWOLEVEL"])
@pytest.mark.parametrize("rope,h", [("per_head", 64), ("shared", 128), ("shared", 32)],
                         ids=["per_head_tables", "shared_tables", "shared_tables_h32"])
def test_variant_with_rope_matches_jax(env, rope, h, switch):
    calls = switch(env)
    out, ref = _run_both(h=h, rope=rope)
    assert calls == [1]
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


# K7a over several of its 128-key tiles: a ragged last tile (300 = 2*128 + 44;
# 264 with per-head tables), kv_lens inside the second tile (150) and at a tile
# boundary (256), an empty row; H 64 and 128.
TWOPASS_OVER_128 = {
    "ragged_last_tile_h128": dict(h=128, s=300),
    "kv_lens_across_tiles_empty_row_h64": dict(s=300, kv_lens=[150, 256, 0], b=3),
    "per_head_tables_ragged_h64": dict(s=264, rope="per_head"),
}


@pytest.mark.parametrize("jax_block_kv", [32, 128])
@pytest.mark.parametrize("case", sorted(TWOPASS_OVER_128))
def test_twopass_over_128_key_tiles_matches_jax(case, jax_block_kv, switch):
    """K7a's plain version takes its max and sums over 128-key tiles in turn;
    JAX's two-pass kernel at 32- and 128-key blocks."""
    calls = switch("FINETRAINERS_FLASH_TWOPASS")
    kw = TWOPASS_OVER_128[case]
    out, ref = _run_both(jax_block_kv=jax_block_kv, **kw)
    assert calls == [1]
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    if kw.get("kv_lens") and 0 in kw["kv_lens"]:
        assert not out[kw["kv_lens"].index(0)].any()


# K7c and K7b over several of their tiles (128 keys; K7b's score tiles are 64),
# as K7a above: a ragged last tile, kv_lens inside a tile (150) and at a tile
# boundary (256) with an empty row, per-head tables for K7c (RoPE gates K7b
# off), and cross-attention (Sq != Skv) for both.
OVER_128 = {
    "FINETRAINERS_FLASH_TWOLEVEL": {
        "ragged_last_tile_h128": dict(h=128, s=300),
        "kv_lens_across_tiles_empty_row_h64": dict(s=300, kv_lens=[150, 256, 0], b=3),
        "per_head_tables_ragged_h64": dict(s=264, rope="per_head"),
        "cross_attention_empty_row_h64": dict(s=100, s_kv=300, kv_lens=[300, 0]),
        "kv_lens_across_tiles_empty_row_h32": dict(h=32, s=300, kv_lens=[150, 256, 0], b=3),
    },
    "FINETRAINERS_FLASH_SKEW": {
        "ragged_last_tile_h128": dict(h=128, s=300),
        "kv_lens_across_tiles_empty_row_h64": dict(s=300, kv_lens=[150, 256, 0], b=3),
        "cross_attention_kv_lens_h128": dict(h=128, s=200, s_kv=300, kv_lens=[300, 129]),
        "cross_attention_h64": dict(s=300, s_kv=140),
        "kv_lens_across_tiles_empty_row_h32": dict(h=32, s=300, kv_lens=[150, 256, 0], b=3),
    },
}


@pytest.mark.parametrize("jax_block_kv", [32, 128])
@pytest.mark.parametrize("env,case", [(env, case) for env in sorted(OVER_128) for case in sorted(OVER_128[env])])
def test_skew_and_two_level_over_128_key_tiles_match_jax(env, case, jax_block_kv, switch):
    """K7c's and K7b's plain versions run their recurrences over their
    kernels' tiles in turn (128 and 64 keys); JAX's two-level and skewed
    kernels at 32- and 128-key blocks."""
    calls = switch(env)
    kw = OVER_128[env][case]
    out, ref = _run_both(jax_block_kv=jax_block_kv, **kw)
    assert calls == [1]
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    if kw.get("kv_lens") and 0 in kw["kv_lens"]:
        assert not out[kw["kv_lens"].index(0)].any()


@pytest.mark.parametrize("rope", ["per_head", "shared"])
def test_skew_is_gated_off_rope(rope, switch):
    """With RoPE tables the skew switch leaves the straight kernel (K1's plain
    version) in place, bit-equal to the unswitched call, as in JAX."""
    calls = switch("FINETRAINERS_FLASH_SKEW")
    assert forward_variant(has_rope=True) is None
    assert forward_variant(has_rope=False) is port_flash_ops.flash_forward_skew
    skewed, ref = _run_both(rope=rope, s=96)
    assert calls == []
    switch(None)
    straight, _ = _run_both(rope=rope, s=96, with_jax=False)
    np.testing.assert_array_equal(skewed, straight)
    np.testing.assert_allclose(skewed, ref, atol=ATOL, rtol=RTOL)


def test_switch_precedence(switch, monkeypatch):
    """Skew, then two-pass, then two-level, as `_flash_forward` reads them."""
    switch(None)
    assert forward_variant(False) is None
    monkeypatch.setenv("FINETRAINERS_FLASH_TWOLEVEL", "1")
    assert forward_variant(False) is port_flash_ops.flash_forward_two_level
    monkeypatch.setenv("FINETRAINERS_FLASH_TWOPASS", "1")
    assert forward_variant(False) is port_flash_ops.flash_forward_twopass
    monkeypatch.setenv("FINETRAINERS_FLASH_SKEW", "1")
    assert forward_variant(False) is port_flash_ops.flash_forward_skew
    assert forward_variant(True) is port_flash_ops.flash_forward_twopass
