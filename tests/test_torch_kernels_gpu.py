"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: skips without a CUDA card (a CUDA kernel has no CPU mode). It
imports no JAX. On the card:

    python -m pytest tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch

from finetrainers_tpu_torch.ops import attention as attention_ops
from finetrainers_tpu_torch.ops import attention_dispatch, list_providers
from finetrainers_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction,
    dkdv_splits,
    flash_attention_reference,
    flash_backward,
    flash_backward_fused_reference,
    flash_backward_reference,
    flash_bwd_dkdv,
    flash_bwd_dkdv_reference,
    flash_bwd_dq,
    flash_bwd_dq_emit,
    flash_bwd_dq_reference,
    flash_bwd_fused,
    flash_forward,
    flash_forward_core,
    flash_forward_core_reference,
    flash_forward_skew,
    flash_forward_skew_reference,
    flash_forward_two_level,
    flash_forward_two_level_reference,
    flash_forward_twopass,
    flash_forward_twopass_reference,
    flash_qk_prep,
    kernel_tables,
)
from finetrainers_tpu_torch.ops.sage_attention import (
    sage_attention_reference,
    sage_forward,
    sage_prep,
    sage_quantize,
)

# (B, N, Sq, Skv, H, rope, kv_lens): fused RoPE with per-head and shared tables,
# kv_lens with an empty row, sequence lengths off every tile boundary, H = 64 and 128.
CASES = [
    (2, 2, 60, 60, 64, "per_head", None),
    (1, 3, 37, 37, 64, "shared", None),
    (3, 2, 40, 20, 64, None, [20, 7, 0]),
    (1, 2, 300, 300, 128, None, None),
    (1, 2, 48, 48, 128, "per_head", None),
    (2, 4, 1000, 77, 64, None, [77, 30]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_forward_kernel_matches_reference(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, n, sq, skv, h, rope, lens in CASES:
        q, k, v = (torch.randn(b, n, s, h, device="cuda", generator=g).to(dtype) for s in (sq, skv, skv))
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        cos = sin = None
        if rope:
            ang = torch.rand(1 if rope == "shared" else n, sq, h // 2, device="cuda", generator=g) * 6.3
            cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
        before = _forward_counts()
        out, lse = flash_forward(q, k, v, kv_lens, cos, sin)
        torch.cuda.synchronize()
        assert _forward_counts() == tuple(c + d for c, d in zip(before, (1, 1, 0, 0)))
        ref_out, ref_lse = flash_attention_reference(q, k, v, kv_lens, cos, sin)
        # bf16/fp16 output against an fp32 reference: about two units in the last place.
        torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _forward_counts():
    """Launches of the pre-pass, K1, K2 and K3."""
    return flash_qk_prep.launches, flash_forward.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches


# (B, N, Sq, Skv, H, rope, kv_lens) for K1 on BNSH views of BTNH buffers, as the model hands them
# over: lengths of 1000 and 77 (off every 128-row tile), an empty row, per-head and shared tables.
K1_VIEW_CASES = [
    (2, 3, 1000, 1000, 64, "per_head", None),
    (1, 2, 1000, 1000, 128, "shared", None),
    (2, 4, 1000, 77, 64, None, [77, 0]),
    (2, 2, 77, 1000, 128, None, [77, 0]),
    (2, 2, 77, 77, 128, "per_head", [77, 0]),
    (2, 2, 77, 77, 64, "shared", [30, 0]),
]
# chip_smoke.py's K1 bounds: |out - ref| <= K1_TOL * max(1, |ref|) elementwise (about two units in
# the last place of a bf16 value) and the LSE within LSE_TOL.
K1_TOL, LSE_TOL = 2e-2, 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_on_btnh_views_matches_reference(dtype, head_dim):
    """The pre-pass and the wgmma K1 against `flash_attention_reference`, and K1
    alone against its plain version on the same q_s/k_r; each call launches the
    pre-pass once and K1 once, and neither K2 nor K3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(7)
    for b, n, sq, skv, _, rope, lens in [c for c in K1_VIEW_CASES if c[4] == head_dim]:
        q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        cos, sin = _tables(rope, n, sq, head_dim, g)
        before = _forward_counts()
        out, lse = flash_forward(q, k, v, kv_lens, cos, sin)
        torch.cuda.synchronize()
        assert _forward_counts() == tuple(c + d for c, d in zip(before, (1, 1, 0, 0)))
        assert out.dtype == dtype and out.transpose(1, 2).is_contiguous()
        ref, ref_lse = flash_attention_reference(q, k, v, kv_lens, cos, sin)
        err = (out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)
        assert err.max().item() <= K1_TOL, (b, n, sq, skv, head_dim, rope, lens, err.max().item())
        assert (lse - ref_lse).abs().max().item() <= LSE_TOL, (b, n, sq, skv, head_dim, rope, lens)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * head_dim
        q_s, k_r = flash_qk_prep(q, k, cos, sin, rope_sn, head_dim**-0.5)
        core, core_lse = flash_forward_core(q_s, k_r, v, kv_lens)
        assert torch.equal(core, out) and torch.equal(core_lse, lse)
        plain, plain_lse = flash_forward_core_reference(q_s, k_r, v, kv_lens)
        assert ((core.float() - plain.float()).abs() / plain.float().abs().clamp_min(1.0)).max().item() <= K1_TOL
        assert (core_lse - plain_lse).abs().max().item() <= LSE_TOL
        if lens is not None and 0 in lens:
            empty = lens.index(0)
            assert not out[empty].any()
            torch.testing.assert_close(lse[empty], torch.full_like(lse[empty], -1e30 * 0.6931471805599453),
                                       rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
def test_k1_ignores_k_and_v_rows_past_kv_lens(head_dim):
    """TMA reads the rows of k and v between kv_lens[b] and Skv: filled with large
    finite values, they must leave out and LSE bit-equal to the same call with
    those rows zeroed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(8)
    b, n, sq, skv, lens = 3, 2, 300, 333, [1, 200, 0]
    q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(torch.bfloat16).transpose(1, 2)
               for s in (sq, skv, skv))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    runs = []
    for k_fill, v_fill in ((3e4, -3e4), (0.0, 0.0)):
        k_f, v_f = k.clone(), v.clone()
        for bi, length in enumerate(lens):
            k_f[bi, :, length:] = k_fill
            v_f[bi, :, length:] = v_fill
        runs.append(flash_forward(q, k_f, v_f, kv_lens))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert torch.isfinite(runs[0][0]).all()


@pytest.mark.gpu
def test_flash_forward_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(1, 2, 16, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_forward(q, q, q)
    q = torch.zeros(1, 2, 16, 64, device="cuda", dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        flash_forward(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("provider", ["auto", "flash"])
def test_default_provider_raises_on_the_card_where_k1_does_not_apply(provider):
    """On a CUDA tensor `auto` never falls back to plain math: an fp32 call or a
    head dim K1 does not take raises, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = flash_forward.launches
    for dtype, h in ((torch.float32, 64), (torch.bfloat16, 32)):
        q = torch.zeros(1, 16, 2, h, device="cuda", dtype=dtype)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            attention_dispatch(q, q, q, provider=provider)
    assert flash_forward.launches == before


def _rel_errors(got, ref):
    """Relative L2 error and max error over max |ref|."""
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().clamp_min(1e-30)
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item(), ((got - ref).abs().max() / scale).item()


def _tables(rope, n, s, h, g):
    if not rope:
        return None, None
    ang = torch.rand(1 if rope == "shared" else n, s, h // 2, device="cuda", generator=g) * 6.3
    return tuple(f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_backward_kernels_match_reference(dtype):
    """K2 and K3 (after the pre-pass) against `flash_backward_reference` on the
    same inputs and the same K1 `out`/LSE. The inputs are BNSH views of BTNH
    buffers, as the model hands them over. Bound: relative L2 <= 1e-2 and max
    error <= 2e-2 of max |ref| (the kernels' exp2 and fp32 sums round a p or a
    ds to the neighbouring bf16 value now and then)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    for b, n, sq, skv, h, rope, lens in CASES:
        q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        cos, sin = _tables(rope, n, sq, h, g)
        out, lse = flash_forward(q, k, v, kv_lens, cos, sin)
        do = torch.randn(b, sq, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2)
        before = (flash_qk_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches)
        grads = flash_backward(q, k, v, out, lse, do, kv_lens, cos, sin)
        torch.cuda.synchronize()
        assert (flash_qk_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches) == tuple(
            c + 1 for c in before)
        refs = flash_backward_reference(q, k, v, out, lse, do, kv_lens, cos, sin)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            assert got.dtype == dtype and got.shape == ref.shape
            assert torch.isfinite(got).all(), (name, b, n, sq, skv, h, rope, lens)
            rel_l2, max_ratio = _rel_errors(got, ref)
            assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, b, n, sq, skv, h, rope, lens, rel_l2, max_ratio)
        if lens is not None and 0 in lens:  # an empty row: no gradient at all
            empty = lens.index(0)
            assert not grads[0][empty].any() and not grads[1][empty].any() and not grads[2][empty].any()


@pytest.mark.gpu
def test_auto_is_differentiable_through_k4_on_the_card():
    """A requires_grad call through `auto` has K4's grad_fn, and its gradients
    are K4's, launched once per K2 and K3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(2)
    b, s, n, h = 2, 96, 4, 64
    q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g, dtype=torch.bfloat16) for _ in range(3))
    ang = torch.rand(s, n * h // 2, device="cuda", generator=g) * 6.3
    cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
    do = torch.randn(b, s, n, h, device="cuda", generator=g, dtype=torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_dispatch(*leaves, provider="auto", rope_freqs=(cos, sin))
    assert "FlashAttentionFunction" in type(out.grad_fn.next_functions[0][0]).__name__
    before = (flash_bwd_dkdv.launches, flash_bwd_dq.launches)
    grads = torch.autograd.grad(out, leaves, do)
    assert (flash_bwd_dkdv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tables = tuple(t.reshape(s, n, h).transpose(0, 1).contiguous() for t in (cos, sin))
    out = FlashAttentionFunction.apply(*(x.transpose(1, 2) for x in leaves), None, *tables, h**-0.5)
    direct = torch.autograd.grad(out, leaves, do.transpose(1, 2))
    for got, ref in zip(grads, direct):
        assert torch.equal(got, ref)


@pytest.mark.gpu
def test_flash_backward_rejects_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lse = torch.zeros(1, 2, 16, device="cuda")
    before = (flash_qk_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches)
    q = torch.zeros(1, 2, 16, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_backward(q, q, q, q, lse, q)
    q = torch.zeros(1, 2, 16, 64, device="cuda", dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        flash_backward(q, q, q, q, lse, q)
    q = torch.zeros(1, 2, 16, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do must match q"):
        flash_backward(q, q, q, q, lse, q[:, :, :8])
    k = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16)
    cos = torch.ones(1, 16, 64, device="cuda")
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_backward(q, k, k, q, lse, q, rope_cos=cos, rope_sin=cos)
    assert (flash_qk_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches) == before


_VARIANTS = {
    "two_level": (flash_forward_two_level, flash_forward_two_level_reference),
    "twopass": (flash_forward_twopass, flash_forward_twopass_reference),
    "skew": (flash_forward_skew, flash_forward_skew_reference),
}


# Further cases for the wgmma K7a and K5 (B, N, Sq, Skv, H, rope, kv_lens): several 128-key tiles
# with a ragged last one, kv_lens inside a tile and an empty row, cross-attention over 512 keys whose
# K5 q loop `dkdv_splits` cuts over CTAs, and a single key tile.
SM90_VARIANT_CASES = [
    (2, 2, 300, 300, 128, "shared", None),
    (2, 3, 333, 333, 64, "per_head", None),
    (3, 2, 200, 333, 128, None, [333, 150, 0]),
    (1, 4, 4100, 512, 128, None, [300]),
    (3, 2, 200, 333, 64, None, [1, 200, 0]),
    (1, 2, 129, 129, 64, None, [129]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_forward_variant_kernels_match_reference(variant, dtype):
    """K7a/b/c against their own plain versions and against K1's, with K1's
    bounds (the skewed kernel takes no RoPE tables: its cases drop them), on
    BNSH views of BTNH buffers; K7a also at the cases over several 128-key
    tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    kernel, reference = _VARIANTS[variant]
    g = torch.Generator(device="cuda").manual_seed(5)
    for b, n, sq, skv, h, rope, lens in CASES + (SM90_VARIANT_CASES if variant == "twopass" else []):
        if variant == "skew":
            rope = None
        q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        cos, sin = _tables(rope, n, sq, h, g)
        before = kernel.launches
        out, lse = kernel(q, k, v, kv_lens, cos, sin)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for ref_out, ref_lse in (reference(q, k, v, kv_lens, cos, sin), flash_attention_reference(q, k, v, kv_lens,
                                                                                                  cos, sin)):
            torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=2e-2)
            torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
        if lens is not None and 0 in lens:
            assert not out[lens.index(0)].any()


@pytest.mark.gpu
def test_forward_switches_pick_the_kernel(monkeypatch):
    """Each switch sends `flash_forward` to its kernel, with the JAX package's
    precedence; FINETRAINERS_FLASH_SKEW with RoPE tables stays on K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.randn(1, 2, 100, 64, device="cuda").to(torch.bfloat16)
    cos = torch.ones(1, 100, 64, device="cuda")
    sin = torch.zeros(1, 100, 64, device="cuda")
    counters = (flash_forward, flash_forward_two_level, flash_forward_twopass, flash_forward_skew)
    for env, tables, launched in (
        ("FINETRAINERS_FLASH_TWOLEVEL", False, flash_forward_two_level),
        ("FINETRAINERS_FLASH_TWOPASS", True, flash_forward_twopass),
        ("FINETRAINERS_FLASH_SKEW", False, flash_forward_skew),
        ("FINETRAINERS_FLASH_SKEW", True, flash_forward),
    ):
        monkeypatch.setenv(env, "1")
        before = [c.launches for c in counters]
        prep_before = flash_qk_prep.launches
        flash_forward(q, q, q, None, *((cos, sin) if tables else (None, None)))
        assert [c.launches - n for c, n in zip(counters, before)] == [int(c is launched) for c in counters], env
        # Every forward but K7b runs the pre-pass first.
        assert flash_qk_prep.launches - prep_before == int(launched is not flash_forward_skew), env
        monkeypatch.delenv(env)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_backward_kernel_matches_reference(dtype, monkeypatch):
    """K5 and its dq emit (after the pre-pass) against
    `flash_backward_fused_reference`, with K2/K3's bounds, on BNSH views of
    BTNH buffers, H 64 and 128, Skv off the 128-key tile and a cross-attention
    case whose q loop is split over CTAs; K5 adds dq with TMA reduces, so dq's
    fp32 sum order varies from run to run within them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("FINETRAINERS_FLASH_FUSED_BWD", "1")
    g = torch.Generator(device="cuda").manual_seed(6)
    for b, n, sq, skv, h, rope, lens in CASES + SM90_VARIANT_CASES:
        q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        cos, sin = _tables(rope, n, sq, h, g)
        out, lse = flash_forward(q, k, v, kv_lens, cos, sin)
        do = torch.randn(b, sq, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2)
        counters = (flash_qk_prep, flash_bwd_dkdv, flash_bwd_dq, flash_bwd_fused, flash_bwd_dq_emit)
        before = [c.launches for c in counters]
        grads = flash_backward(q, k, v, out, lse, do, kv_lens, cos, sin)
        torch.cuda.synchronize()
        assert [c.launches - n_ for c, n_ in zip(counters, before)] == [1, 0, 0, 1, 1]
        refs = flash_backward_fused_reference(q, k, v, out, lse, do, kv_lens, cos, sin)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            assert got.dtype == dtype and got.shape == ref.shape
            assert torch.isfinite(got).all(), (name, b, n, sq, skv, h, rope, lens)
            rel_l2, max_ratio = _rel_errors(got, ref)
            assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, b, n, sq, skv, h, rope, lens, rel_l2, max_ratio)
        if lens is not None and 0 in lens:
            empty = lens.index(0)
            assert not grads[0][empty].any() and not grads[1][empty].any() and not grads[2][empty].any()


# (B, N, Sq, Skv, rope, kv_lens) for the wgmma K2 and K3, run at H=64 and H=128 on BNSH views of
# BTNH buffers: per-head (LTX) and shared (Wan) tables, lengths off every tile boundary (1000 q rows
# over 77 keys; 4100), an empty row, and cross-attention shapes whose q loop K2 splits over CTAs.
K2K3_CASES = [
    (1, 2, 4100, 4100, "per_head", None),
    (1, 3, 4100, 4100, "shared", None),
    (2, 4, 1000, 77, None, [77, 0]),
    (2, 3, 1000, 1000, "shared", None),
    (1, 4, 4100, 512, None, [300]),
    (3, 2, 200, 333, None, [1, 200, 0]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k2_k3_match_their_plain_versions(dtype, head_dim):
    """K2 (`flash_bwd_dkdv`, with its reduce pass where `dkdv_splits` cuts the
    q loop) and K3 (`flash_bwd_dq`) on the pre-pass's operands against
    `flash_bwd_dkdv_reference` (cut at the same q rows) and
    `flash_bwd_dq_reference`, with `chip_smoke.py`'s backward bounds: relative
    L2 <= 1e-2 and max error <= 2e-2 of max |ref|. A batch row with no valid key
    gets exactly zero gradients; each call launches its kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, n, sq, skv, rope, lens in K2K3_CASES:
        q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        do = torch.randn(b, sq, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        cos, sin = _tables(rope, n, sq, head_dim, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * head_dim
        scale = head_dim**-0.5
        out, lse = flash_forward(q, k, v, kv_lens, cos, sin)
        delta = (do.float() * out.float()).sum(-1)
        q_s, k_r = flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        operands = (q_s, k_r, v, do, lse, delta, kv_lens, cos, sin)
        before = (flash_bwd_dkdv.launches, flash_bwd_dq.launches)
        dk, dv = flash_bwd_dkdv(*operands, rope_sn)
        dq = flash_bwd_dq(*operands, rope_sn, scale)
        torch.cuda.synchronize()
        assert (flash_bwd_dkdv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
        splits = dkdv_splits(b, n, sq, skv, sms)[0]
        refs = (dq, flash_bwd_dq_reference(*operands, scale)), *zip((dk, dv), flash_bwd_dkdv_reference(*operands,
                                                                                                          splits))
        case = (b, n, sq, skv, head_dim, rope, lens, splits)
        for name, (got, ref) in zip(("dq", "dk", "dv"), refs):
            assert got.dtype == dtype and got.shape == ref.shape and got.transpose(1, 2).is_contiguous()
            assert torch.isfinite(got).all(), (name, case)
            rel_l2, max_ratio = _rel_errors(got, ref)
            assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, case, rel_l2, max_ratio)
        if lens is not None and 0 in lens:
            empty = lens.index(0)
            assert not dq[empty].any() and not dk[empty].any() and not dv[empty].any(), case


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k2_k3_ignore_k_and_v_rows_past_kv_lens(dtype, head_dim):
    """TMA reads the rows of k and v between kv_lens[b] and Skv: filled with
    +-3e4, they must leave dq, dk and dv bit-equal to the same call with those
    rows zeroed (self-attention lengths, and a cross-attention shape whose K2 q
    loop is split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(12)
    for b, n, sq, skv, lens in ((3, 2, 300, 333, [1, 200, 0]), (1, 4, 4100, 512, [300])):
        q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        do = torch.randn(b, sq, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        runs = []
        for k_fill, v_fill in ((3e4, -3e4), (0.0, 0.0)):
            k_f, v_f = k.clone(), v.clone()
            for bi, length in enumerate(lens):
                k_f[bi, :, length:] = k_fill
                v_f[bi, :, length:] = v_fill
            out, lse = flash_forward(q, k_f, v_f, kv_lens)
            runs.append((out, lse, flash_backward(q, k_f, v_f, out, lse, do, kv_lens)))
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
        for name, big, zeroed in zip(("dq", "dk", "dv"), runs[0][2], runs[1][2]):
            assert torch.isfinite(big).all() and torch.equal(big, zeroed), (name, b, n, sq, skv, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k5_k7a_ignore_k_and_v_rows_past_kv_lens(dtype, head_dim, monkeypatch):
    """TMA reads the rows of k and v between kv_lens[b] and the end of their
    128-key tile. Filled with NaN, they must leave K7a's out and LSE, and K5's
    dk and dv, bit-equal to the same call with those rows zeroed; K5's dq
    differs only by the order of its fp32 sums (K2/K3's bounds), and all are
    finite. Self-attention lengths, and a cross-attention shape whose K5 q loop
    is split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("FINETRAINERS_FLASH_FUSED_BWD", "1")
    g = torch.Generator(device="cuda").manual_seed(13)
    for b, n, sq, skv, lens in ((3, 2, 300, 333, [1, 200, 0]), (1, 4, 4100, 512, [300])):
        q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        do = torch.randn(b, sq, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out, lse = flash_forward(q, k, v, kv_lens)  # K1 on finite rows: the backward's out and LSE
        runs = []
        for fill in (float("nan"), 0.0):
            k_f, v_f = k.clone(), v.clone()
            for bi, length in enumerate(lens):
                k_f[bi, :, length:] = fill
                v_f[bi, :, length:] = fill
            runs.append((flash_forward_twopass(q, k_f, v_f, kv_lens), flash_backward(q, k_f, v_f, out, lse, do,
                                                                                       kv_lens)))
        torch.cuda.synchronize()
        case = (b, n, sq, skv, lens)
        (nan_fwd, nan_grads), (zero_fwd, zero_grads) = runs
        assert all(torch.equal(x, y) for x, y in zip(nan_fwd, zero_fwd)), case
        assert all(torch.isfinite(x).all() for x in nan_grads), case
        assert torch.equal(nan_grads[1], zero_grads[1]) and torch.equal(nan_grads[2], zero_grads[2]), case
        rel_l2, max_ratio = _rel_errors(nan_grads[0], zero_grads[0])
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (case, rel_l2, max_ratio)


# (B, N, Sq, Skv, H, kv_lens): Wan-like H=128 self-attention, cross-attention over
# padded text with few valid keys, LTX's H=64, lengths off every tile boundary, an empty row.
SAGE_CASES = [
    (2, 2, 300, 300, 128, None),
    (1, 3, 129, 520, 128, [9]),
    (2, 4, 256, 256, 64, None),
    (3, 2, 100, 77, 64, [77, 30, 0]),
    (2, 3, 200, 333, 128, [333, 0]),
]
SAGE_NAMES = ("sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda", "_sage_qk_int8_pv_fp16_triton",
              "_sage_qk_int8_pv_fp8_cuda", "_sage_qk_int8_pv_fp8_cuda_sm90")
# K6 against its plain version on the same codes: |out - ref| <= 2e-2 * max(1, |ref|)
# elementwise and relative L2 <= 1e-2 (chip_smoke.py's K6_TOL and K6_REL_L2_TOL: the
# kernel rounds p to v's dtype before P V; the reference keeps it fp32).
K6_TOL, K6_REL_L2_TOL = 2e-2, 1e-2


def _assert_k6_close(out, ref, case):
    err = (out.float() - ref.float()).abs()
    assert (err / ref.float().abs().clamp_min(1.0)).max().item() <= K6_TOL, case
    assert _rel_errors(out, ref)[0] <= K6_REL_L2_TOL, case


def _assert_prep_matches_cpu(got, cpu, case):
    """q codes and scales equal; the smoothed k's mean is summed in another
    order, so k codes within one, different in at most 0.1% of entries, and k
    scales within rtol 1e-5."""
    got = [x.cpu() for x in got]
    assert torch.equal(got[0], cpu[0]) and torch.equal(got[2], cpu[2]), case
    diff = (got[1].int() - cpu[1].int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3, case
    torch.testing.assert_close(got[3], cpu[3], rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sage_kernel_matches_reference(dtype):
    """K6 against `sage_attention_reference` on the same codes and scales, at
    H=64 and 128, Skv off the 128-key tile, kv_lens with an empty row. q/k/v
    are BNSH views of BTNH buffers and the codes come from the pre-pass kernel
    on the card; a row with no valid key gives exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    for b, n, sq, skv, h, lens in SAGE_CASES:
        q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype) for s in (sq, skv, skv))
        k = k + 1.5  # a channel offset, which smooth-K removes
        kv_lens = torch.tensor(lens if lens else [skv] * b, dtype=torch.int32, device="cuda")
        codes = sage_prep(q, k, kv_lens)
        before = sage_forward.launches
        out = sage_forward(*codes, v.transpose(1, 2), kv_lens)
        torch.cuda.synchronize()
        assert sage_forward.launches == before + 1
        ref = sage_attention_reference(*codes, v.transpose(1, 2), kv_lens)
        assert out.dtype == dtype and out.shape == ref.shape
        _assert_k6_close(out, ref, (b, n, sq, skv, h, lens))
        if lens and 0 in lens:
            assert not out[lens.index(0)].any()


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k6_ignores_codes_scales_and_v_past_kv_lens(dtype, head_dim):
    """TMA reads the k codes, k scales and v rows between kv_lens[b] and Skv:
    filled with codes of +-127, scales of 1e4 and v of +-3e4, they must leave
    the output bit-equal to the same call with those rows zeroed, and within
    K6's tolerance of the plain version; an empty row stays exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(13)
    b, n, sq, skv, lens = 3, 2, 300, 333, [1, 200, 0]
    q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype) for s in (sq, skv, skv))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q_codes, k_codes, q_scales, k_scales = sage_prep(q, k, kv_lens)
    vt = v.transpose(1, 2)
    runs = []
    for code, scale, v_fill in ((127, 1e4, 3e4), (0, 0.0, 0.0)):
        kc, ks, vf = k_codes.clone(), k_scales.clone(), vt.clone()
        for bi, length in enumerate(lens):
            kc[bi, :, length:] = code
            kc[bi, :, length:, ::2] = -code
            ks[bi, :, length:] = scale
            vf[bi, :, length:] = v_fill
        runs.append(sage_forward(q_codes, kc, q_scales, ks, vf, kv_lens))
    torch.cuda.synchronize()
    assert torch.isfinite(runs[0]).all() and torch.equal(runs[0], runs[1])
    _assert_k6_close(runs[0], sage_attention_reference(q_codes, k_codes, q_scales, k_scales, vt, kv_lens),
                     (dtype, head_dim))
    assert not runs[0][2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [None, "shared", "per_head"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sage_prep_matches_the_cpu_plain_prepass(dtype, head_dim, rope):
    """The pre-pass kernel against `sage_quantize` on the CPU copy: q codes and
    scales equal (the rotation's products and sum are rounded one at a time on
    both), k codes within one in at most 0.1% of entries and k scales within
    rtol 1e-5 (the smoothed k's mean is summed in another order); BTNH inputs
    as views of a larger buffer, kv_lens of Skv, of part of it and of 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(14)
    b, n, s = 3, 3, 300
    qkv = torch.randn(b, s, 3, n, head_dim, device="cuda", generator=g).to(dtype)
    qkv[:, :, 1] += 2.0 * qkv[:1, :1, 2].clone()  # a channel offset, which smooth-K removes
    q, k = qkv[:, :, 0], qkv[:, :, 1]  # strided views
    cos, sin = _tables(rope, n, s, head_dim, g)
    kv_lens = torch.tensor([s, 123, 0], dtype=torch.int32, device="cuda")
    before = sage_prep.launches
    got = sage_prep(q, k, kv_lens, cos, sin)
    torch.cuda.synchronize()
    assert sage_prep.launches == before + 1
    assert [tuple(x.shape) for x in got] == [(b, n, s, head_dim)] * 2 + [(b, n, s)] * 2
    assert all(x.is_contiguous() for x in got)
    cpu = sage_quantize(q.cpu(), k.cpu(), kv_lens.cpu(), *(None if t is None else t.cpu() for t in (cos, sin)))
    _assert_prep_matches_cpu(got, cpu, (dtype, head_dim, rope))


@pytest.mark.gpu
def test_sage_prepass_on_the_card_matches_the_cpu():
    """The plain pre-pass (torch ops) on the card against the same ops on the
    CPU: q codes and scales equal; the smoothed k's mean is summed in another
    order, so at most 0.1% of k codes may differ, by one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn(2, 500, 4, 128, generator=g).to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([500, 123], dtype=torch.int32)
    cpu = sage_quantize(q, k, lens)
    gpu = sage_quantize(q.cuda(), k.cuda(), lens.cuda())
    assert torch.equal(gpu[0].cpu(), cpu[0]) and torch.equal(gpu[2].cpu(), cpu[2])
    diff = (gpu[1].cpu().int() - cpu[1].int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    torch.testing.assert_close(gpu[3].cpu(), cpu[3], rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_every_sage_name_reaches_k6_or_raises_on_the_card():
    """Each sage provider name launches the pre-pass and K6 once for a bf16
    call with a padding mask, and raises (launching nothing) for fp32, a causal
    call and a dense mask beside kv_lens: no sage name falls to plain math on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert set(SAGE_NAMES) <= set(list_providers())
    q = torch.randn(2, 40, 2, 64, device="cuda").to(torch.bfloat16)
    mask = (torch.arange(40, device="cuda")[None, :] < torch.tensor([[40], [11]], device="cuda"))[:, None, None, :]
    lens = torch.tensor([40, 11], dtype=torch.int32, device="cuda")
    for name in SAGE_NAMES:
        before, prep_before = sage_forward.launches, sage_prep.launches
        out = attention_dispatch(q, q, q, attn_mask=mask, provider=name)
        assert sage_forward.launches == before + 1 and sage_prep.launches == prep_before + 1
        assert out.shape == q.shape
        ref = attention_dispatch(q, q, q, kv_lens=lens, provider=name)
        assert torch.equal(out, ref)
        with pytest.raises(ValueError, match="bf16 or fp16"):
            attention_dispatch(q.float(), q.float(), q.float(), provider=name)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            attention_dispatch(q, q, q, is_causal=True, provider=name)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            attention_dispatch(q, q, q, attn_mask=mask, kv_lens=lens, provider=name)
        assert sage_forward.launches == before + 2 and sage_prep.launches == prep_before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("tables", ["shared", "full_inner_dim"])
def test_sage_dispatch_on_the_card_never_rotates_in_torch(tables, monkeypatch):
    """Under every sage name a CUDA call with RoPE tables hands them to the
    pre-pass kernel: the dispatcher's torch rotation is never reached, and the
    result is K6 on the codes of the CPU's plain pre-pass with the same tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def no_rotation(*args):
        raise AssertionError("the sage path rotated q or k in torch")

    monkeypatch.setattr(attention_ops, "_rotate_interleaved_4d", no_rotation)
    g = torch.Generator(device="cuda").manual_seed(15)
    b, s, n, h = 2, 260, 3, 128
    q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g).to(torch.bfloat16) for _ in range(3))
    ang = torch.rand(s, h // 2 if tables == "shared" else n * h // 2, device="cuda", generator=g) * 6.3
    cos, sin = (f(ang).repeat_interleave(2, -1) for f in (torch.cos, torch.sin))
    lens = torch.tensor([s, 77], dtype=torch.int32, device="cuda")
    kernel_cos, kernel_sin = kernel_tables(q, k, cos, sin)
    cpu = sage_quantize(q.cpu(), k.cpu(), lens.cpu(), kernel_cos.cpu(), kernel_sin.cpu())
    ref = sage_forward(*(x.cuda() for x in cpu), v.transpose(1, 2), lens).transpose(1, 2)
    for name in SAGE_NAMES:
        before = sage_prep.launches
        out = attention_dispatch(q, k, v, kv_lens=lens, provider=name, rope_freqs=(cos, sin))
        torch.cuda.synchronize()
        assert sage_prep.launches == before + 1
        _assert_k6_close(out, ref, name)
