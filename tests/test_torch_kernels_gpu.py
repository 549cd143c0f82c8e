"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: skips without a CUDA card (a CUDA kernel has no CPU mode). It
imports no JAX. On the card:

    python -m pytest tests/test_torch_kernels_gpu.py -q
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
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
from finetrainers_tpu_torch.trainer import SFTTrainer

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
# over: lengths of 1000 and 77 (off every 128-row tile), an empty row, per-head and shared tables; at
# H=32 also the dummy family's cross-attention over its 16 caption slots.
K1_VIEW_CASES = [
    (2, 3, 1000, 1000, 64, "per_head", None),
    (1, 2, 1000, 1000, 128, "shared", None),
    (2, 4, 1000, 77, 64, None, [77, 0]),
    (2, 2, 77, 1000, 128, None, [77, 0]),
    (2, 2, 77, 77, 128, "per_head", [77, 0]),
    (2, 2, 77, 77, 64, "shared", [30, 0]),
    (2, 3, 1000, 1000, 32, "per_head", None),
    (1, 2, 4352, 16, 32, None, [16]),
    (2, 2, 77, 1000, 32, None, [77, 0]),
]
# chip_smoke.py's K1 bounds: |out - ref| <= K1_TOL * max(1, |ref|) elementwise (about two units in
# the last place of a bf16 value) and the LSE within LSE_TOL.
K1_TOL, LSE_TOL = 2e-2, 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [32, 64, 128])
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
@pytest.mark.parametrize("head_dim", [32, 64, 128])
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
    q = torch.zeros(1, 2, 16, 48, device="cuda", dtype=torch.bfloat16)
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
    for dtype, h in ((torch.float32, 64), (torch.bfloat16, 48)):
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
    q = torch.zeros(1, 2, 16, 48, device="cuda", dtype=torch.bfloat16)
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


# Further cases for the wgmma K7a-c and K5 (B, N, Sq, Skv, H, rope, kv_lens): several 128-key tiles
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
    BNSH views of BTNH buffers, also at the cases over several 128-key tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    kernel, reference = _VARIANTS[variant]
    g = torch.Generator(device="cuda").manual_seed(5)
    for b, n, sq, skv, h, rope, lens in CASES + SM90_VARIANT_CASES:
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
@pytest.mark.parametrize("variant", ["two_level", "skew"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_k7b_k7c_ignore_k_and_v_rows_past_kv_lens(variant, head_dim):
    """TMA reads the rows of k and v between kv_lens[b] and the end of their
    128-key tile: filled with large finite values, they must leave K7c's and
    K7b's out and LSE bit-equal to the same call with those rows zeroed, as
    K1's (self-attention lengths, and cross-attention over 512 keys)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    kernel = _VARIANTS[variant][0]
    g = torch.Generator(device="cuda").manual_seed(14)
    for b, n, sq, skv, lens in ((3, 2, 300, 333, [1, 200, 0]), (2, 4, 1000, 512, [300, 9])):
        q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(torch.bfloat16).transpose(1, 2)
                   for s in (sq, skv, skv))
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        runs = []
        for k_fill, v_fill in ((3e4, -3e4), (0.0, 0.0)):
            k_f, v_f = k.clone(), v.clone()
            for bi, length in enumerate(lens):
                k_f[bi, :, length:] = k_fill
                v_f[bi, :, length:] = v_fill
            runs.append(kernel(q, k_f, v_f, kv_lens))
        torch.cuda.synchronize()
        case = (b, n, sq, skv, lens)
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1]), case
        assert torch.isfinite(runs[0][0]).all(), case


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
@pytest.mark.parametrize("head_dim", [32, 64, 128])
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
@pytest.mark.parametrize("head_dim,axes", [(64, (16, 24, 24)), (128, (16, 56, 56))], ids=["h64", "h128"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_k3_at_a_16_row_last_tile_with_flux_tables(dtype, head_dim, axes):
    """Flux's joint attention: 32 text rows (zero ids, so identity rows in the
    tables) and a 30x32 latent's 15x16 image rows, 272 = 2 x 128 + 16 rows, so
    the last q and kv tiles hold 16 (the flux_dev example's 4112 tokens end
    the same way). K1 after the pre-pass against `flash_attention_reference`
    (|out - ref| <= 2e-2 max(1, |ref|), LSE within 1e-2), then K2 and K3
    against `flash_backward_reference` (relative L2 <= 1e-2, max error <=
    2e-2 of max |ref|), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from finetrainers_tpu_torch.models.flux import flux_rope_freqs, prepare_latent_image_ids, rope_tables

    text, b, n = 32, 1, 3
    ids = torch.cat([torch.zeros(text, 3, device="cuda"), prepare_latent_image_ids(30, 32, torch.device("cuda"))])
    s = ids.shape[0]
    assert s % 128 == 16
    cos, sin = (t[None].contiguous() for t in rope_tables(*flux_rope_freqs(ids, axes)))
    assert torch.equal(cos[0, :text], torch.ones(text, head_dim, device="cuda")) and not sin[0, :text].any()
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for _ in range(4))
    before = (flash_forward.launches, flash_qk_prep.launches)
    out, lse = flash_forward(q, k, v, None, cos, sin)
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_qk_prep.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_lse = flash_attention_reference(q, k, v, None, cos, sin)
    assert ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max() <= 2e-2
    assert (lse - ref_lse).abs().max() <= 1e-2
    before = (flash_bwd_dkdv.launches, flash_bwd_dq.launches)
    grads = flash_backward(q, k, v, out, lse, do, None, cos, sin)
    torch.cuda.synchronize()
    assert (flash_bwd_dkdv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    for name, got, want in zip(("dq", "dk", "dv"), grads, flash_backward_reference(q, k, v, out, lse, do, None, cos,
                                                                                     sin)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        rel_l2, max_ratio = _rel_errors(got, want)
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, head_dim, rel_l2, max_ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,axes", [(64, (16, 24, 24)), (128, (16, 56, 56))], ids=["h64", "h128"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_k3_at_a_32_row_last_tile_with_frame_axis_tables(dtype, head_dim, axes):
    """HunyuanVideo's joint attention: 32 text rows (zero ids, identity rows in
    the tables) and 2 latent frames of 8 x 8 patches whose (frame, row, col)
    ids move the frame axis too, 160 = 128 + 32 rows, so the last q and kv
    tiles hold 32 (the example's 256 + 18,720 = 18,976 tokens end the same
    way). K1 after the pre-pass, K2 and K3 against their references, as for
    Flux's tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from finetrainers_tpu_torch.models.flux import flux_rope_freqs, rope_tables
    from finetrainers_tpu_torch.models.hunyuan_video import video_ids

    text, b, n = 32, 1, 3
    ids = torch.cat([torch.zeros(text, 3, device="cuda"), video_ids(2, 8, 8, torch.device("cuda"))])
    s = ids.shape[0]
    assert s % 128 == 32 and ids[:, 0].max() == 1
    cos, sin = (t[None].contiguous() for t in rope_tables(*flux_rope_freqs(ids, axes)))
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for _ in range(4))
    before = (flash_forward.launches, flash_qk_prep.launches)
    out, lse = flash_forward(q, k, v, None, cos, sin)
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_qk_prep.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_lse = flash_attention_reference(q, k, v, None, cos, sin)
    assert ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max() <= 2e-2
    assert (lse - ref_lse).abs().max() <= 1e-2
    grads = flash_backward(q, k, v, out, lse, do, None, cos, sin)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, flash_backward_reference(q, k, v, out, lse, do, None, cos,
                                                                                     sin)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        rel_l2, max_ratio = _rel_errors(got, want)
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, head_dim, rel_l2, max_ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2], ids=["train_b1", "cfg_b2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_k3_at_cogview4_joint_shape(dtype, b):
    """CogView4's joint attention at full length: 1024 text slots (identity
    rows in the tables) and a 1024x1024 image's 64x64 patches with the 2D
    RoPE, 5120 = 40 full tiles; B=1 as in training, B=2 as CFG serves it; 2
    of the 32 heads (the plain version holds 5120^2 fp32 scores a head). K1
    after the pre-pass against `flash_attention_reference`, K2 and K3 against
    `flash_backward_reference`, one launch each, as for Flux's tables (at 2
    heads K2 splits its q loop and runs the reduce pass; at 32 its 1280 kv
    CTAs need no split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from finetrainers_tpu_torch.models.cogview4 import cogview4_rope_tables

    text, n, h = 1024, 2, 128
    cos, sin = (t[None].contiguous() for t in cogview4_rope_tables(text, 64, 64, h, torch.device("cuda")))
    s = cos.shape[1]
    assert s == 5120 and s % 128 == 0
    assert torch.equal(cos[0, :text], torch.ones(text, h, device="cuda")) and not sin[0, :text].any()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert dkdv_splits(1, 32, s, s, sms)[0] == 1
    g = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, do = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2) for _ in range(4))
    before = (flash_forward.launches, flash_qk_prep.launches)
    out, lse = flash_forward(q, k, v, None, cos, sin)
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_qk_prep.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_lse = flash_attention_reference(q, k, v, None, cos, sin)
    assert ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max() <= 2e-2
    assert (lse - ref_lse).abs().max() <= 1e-2
    del ref, ref_lse
    before = (flash_bwd_dkdv.launches, flash_bwd_dq.launches)
    grads = flash_backward(q, k, v, out, lse, do, None, cos, sin)
    torch.cuda.synchronize()
    assert (flash_bwd_dkdv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    for name, got, want in zip(("dq", "dk", "dv"), grads, flash_backward_reference(q, k, v, out, lse, do, None, cos,
                                                                                     sin)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        rel_l2, max_ratio = _rel_errors(got, want)
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, b, rel_l2, max_ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("text,grid", [(2, (2, 8, 8)), (2, (2, 8, 16)), (226, (1, 8, 20))],
                         ids=["s130_q_block_130", "s258_q_block_66", "s386_q_block_2_text_226"])
@pytest.mark.parametrize("tables", [True, False], ids=["cogvideox_tables", "no_tables"])
@pytest.mark.parametrize("b", [1, 2], ids=["train_b1", "cfg_b2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_k3_at_a_2_row_last_tile_with_h64(dtype, b, tables, text, grid):
    """CogVideoX's joint attention at head dim 64, whose example length 30,466
    = 238 x 128 + 2 = 158 x 192 + 130 leaves 2 rows in the last 128-row tile
    of K2, K3 and K1's key loop, and 130 in K1's last 192-row q block (three
    consumer warpgroups at H=64). Lengths whose last 128-row tile holds 2:
    130 (one q block of 130 rows, as at 30,466), 258 (a last q block of 66)
    and 386 (226 text rows, a last q block of 2); with the 3D RoPE
    tables (identity text rows) and without; B=1 as in training and B=2 as CFG
    serves it. K1 after the pre-pass, K2 and K3 against their references, one
    launch each, as for Flux's tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from finetrainers_tpu_torch.models.cogvideox import cogvideox_rope_tables

    n, h = 3, 64
    s = text + grid[0] * grid[1] * grid[2]
    assert s % 128 == 2
    cos = sin = None
    if tables:
        cos, sin = (t[None].contiguous() for t in cogvideox_rope_tables(text, *grid, h, torch.device("cuda")))
        assert cos.shape[1] == s and torch.equal(cos[0, :text], torch.ones(text, h, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2) for _ in range(4))
    before = (flash_forward.launches, flash_qk_prep.launches)
    out, lse = flash_forward(q, k, v, None, cos, sin)
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_qk_prep.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_lse = flash_attention_reference(q, k, v, None, cos, sin)
    assert ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max() <= 2e-2
    assert (lse - ref_lse).abs().max() <= 1e-2
    before = (flash_bwd_dkdv.launches, flash_bwd_dq.launches)
    grads = flash_backward(q, k, v, out, lse, do, None, cos, sin)
    torch.cuda.synchronize()
    assert (flash_bwd_dkdv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    for name, got, want in zip(("dq", "dk", "dv"), grads, flash_backward_reference(q, k, v, out, lse, do, None, cos,
                                                                                     sin)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        rel_l2, max_ratio = _rel_errors(got, want)
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, b, s, rel_l2, max_ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("lens", [[65], [65, 256]], ids=["b1", "b2"])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_k3_at_a_256_key_self_attention_with_a_dead_kv_tile(dtype, head_dim, lens):
    """HunyuanVideo's token refiner: self-attention over 256 text slots of
    which 65 are valid, so the kv tile of keys 128-255 holds no valid key. K1
    skips it: every row, the padded query rows too, matches
    `flash_attention_reference` (those rows go on to the joint blocks, so
    they are attended, not zeroed). K2's q loop is split (4 q tiles of 64
    rows, 2 or 4 kv CTAs per head, fewer than the SMs: 2 splits) and the
    reduce pass runs once; dk and dv are exactly 0 at the keys past kv_lens
    and match `flash_bwd_dkdv_reference`, dq `flash_bwd_dq_reference`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    b, n, s = len(lens), 2, 256
    g = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, do = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for _ in range(4))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out, lse = flash_forward(q, k, v, kv_lens)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_reference(q, k, v, kv_lens)
    assert ((out.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max() <= 2e-2
    assert (lse - ref_lse).abs().max() <= 1e-2
    assert out[0, :, lens[0]:].abs().amax() > 0
    splits = dkdv_splits(b, n, s, s, torch.cuda.get_device_properties(0).multi_processor_count)[0]
    assert splits == 2
    scale = head_dim**-0.5
    delta = (do.float() * out.float()).sum(-1)
    q_s, k_r = flash_qk_prep(q, k, None, None, 0, scale)
    operands = (q_s, k_r, v, do, lse, delta, kv_lens, None, None)
    reduce_before = flash_bwd_dkdv.reduce_launches
    dk, dv = flash_bwd_dkdv(*operands, 0)
    dq = flash_bwd_dq(*operands, 0, scale)
    torch.cuda.synchronize()
    assert flash_bwd_dkdv.reduce_launches == reduce_before + 1
    for bi, length in enumerate(lens):
        assert not dk[bi, :, length:].any() and not dv[bi, :, length:].any(), (bi, length)
    refs = (dq, flash_bwd_dq_reference(*operands, scale)), *zip((dk, dv), flash_bwd_dkdv_reference(*operands, splits))
    for name, (got, want) in zip(("dq", "dk", "dv"), refs):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        rel_l2, max_ratio = _rel_errors(got, want)
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, head_dim, lens, rel_l2, max_ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [32, 64, 128])
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


@pytest.mark.gpu
@pytest.mark.parametrize("policy,k1_per_block", [("full", 4), ("ops", 2), ("ops_attn", 2), ("ops_narrow", 2)])
def test_k1_launches_per_block_under_each_remat_policy(policy, k1_per_block):
    """A small bf16 Wan train step on the card (3 blocks, 2 heads of 128): K1
    runs for self- and cross-attention in the forward, and again in the
    recompute only under `full`; the selective policies save the K4 op. K2
    and K3 run once per attention call, the pre-pass before each K1 and each
    backward. Loss and LoRA gradient equal `full`'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    layers = 3
    config = dict(num_attention_heads=2, attention_head_dim=128, num_layers=layers, ffn_dim=512, text_dim=64,
                  freq_dim=32)
    spec = get_model_specification_cls("wan", "lora")(device="cuda", transformer_config=config, seed=0)
    trainer = SFTTrainer(BaseArgs(training_type="lora", rank=8, lora_alpha=8, seed=0, gradient_checkpointing=True,
                                  gradient_checkpointing_type=policy), spec)
    trainer.prepare()
    g = torch.Generator(device="cuda").manual_seed(1)
    moments = torch.randn(1, 32, 3, 16, 16, device="cuda", generator=g)
    conditions = {"encoder_hidden_states": torch.randn(1, 40, 64, device="cuda", generator=g),
                  "encoder_attention_mask": (torch.arange(40, device="cuda") < 33).to(torch.int32)[None]}
    latents = {"latents": moments, "latents_mean": torch.zeros(16, device="cuda"),
               "latents_std": torch.ones(16, device="cuda")}
    counters = (flash_forward, flash_qk_prep, flash_bwd_dkdv, flash_bwd_dq)
    before = [c.launches for c in counters]
    loss, _ = trainer.forward_backward(conditions, latents, generator=torch.Generator("cuda").manual_seed(5))
    torch.cuda.synchronize()
    launches = [c.launches - n for c, n in zip(counters, before)]
    assert launches == [k1_per_block * layers, (k1_per_block + 2) * layers, 2 * layers, 2 * layers], launches
    grad = torch.cat([p.grad.float().flatten() for p in trainer._trainable.values()])
    trainer.optimizer.zero_grad()
    trainer.transformer.module.gradient_checkpointing = "full"
    full_loss, _ = trainer.forward_backward(conditions, latents, generator=torch.Generator("cuda").manual_seed(5))
    full_grad = torch.cat([p.grad.float().flatten() for p in trainer._trainable.values()])
    assert torch.equal(loss, full_loss)
    assert ((grad - full_grad).norm() / full_grad.norm()).item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [None, "shared"])
def test_k1_k2_k3_ragged_last_tile_at_h128(rope):
    """K1, the pre-pass, K2 and K3 at H=128 where Sq = Skv = 1080 = 8 * 128 + 56,
    so the last q tile and the last kv tile hold 56 rows (the Wan example's
    bucket, 20280 tokens, leaves the same 56): self-attention without kv_lens,
    against `flash_attention_reference` and `flash_backward_reference` on the
    same inputs, with K1's and the backward's bounds (out within 2e-2 *
    max(1, |ref|), LSE within 1e-2; gradients relative L2 <= 1e-2 and max error
    <= 2e-2 of max |ref|), the last tile's rows also on their own. Each input
    is a view into a buffer whose rows past the sequence hold large values,
    which no kernel may read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(21)
    b, n, s, h, pad = 1, 4, 1080, 128, 72
    # BTNH buffers with `pad` rows past the sequence holding large values, viewed as BNSH [:s].
    bufs = [torch.randn(b, s + pad, n, h, device="cuda", generator=g).to(torch.bfloat16) for _ in range(4)]
    for buf in bufs:
        buf[:, s:] = 3e4
    q, k, v, do = (buf[:, :s].transpose(1, 2) for buf in bufs)
    cos, sin = _tables(rope, n, s, h, g)
    out, lse = flash_forward(q, k, v, None, cos, sin)
    ref, ref_lse = flash_attention_reference(q, k, v, None, cos, sin)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all() and (err / ref.float().abs().clamp_min(1.0)).max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-2
    grads = flash_backward(q, k, v, out, lse, do, None, cos, sin)
    refs = flash_backward_reference(q, k, v, out, lse, do, None, cos, sin)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(got).all(), name
        rel_l2, max_ratio = _rel_errors(got, want)
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, rope, rel_l2, max_ratio)
        # The last tile's 56 rows on their own: a store or a load past the sequence would show here first.
        rel_l2, max_ratio = _rel_errors(got[:, :, 1024:], want[:, :, 1024:])
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, rope, "last tile", rel_l2, max_ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("provider", ["auto", "sage"])
def test_image_cross_attention_with_one_key_in_the_last_tile(provider):
    """Wan I2V's image branch: q over 376 = 2 * 128 + 120 tokens attends to 257
    = 2 * 128 + 1 image keys at N=40, H=128, with no kv_lens, so K1's and K6's
    last kv tile holds a single key. Through `attention_dispatch` (BTNH, as the
    model calls it): under `auto` the pre-pass and K1 against
    `flash_attention_reference` (out within 2e-2 * max(1, |ref|); the LSE from
    `flash_forward` within 1e-2), under `sage` the pre-pass and K6 against
    `sage_attention_reference` on the pre-pass's codes (K6's bounds). k and v
    are views into buffers whose rows past 257 hold 3e4, which no kernel may
    read (a row over the one-key tile must not take exp2(-inf - -inf) either)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(31)
    b, n, sq, skv, h, pad = 2, 40, 376, 257, 128, 63
    q = torch.randn(b, sq, n, h, device="cuda", generator=g).to(torch.bfloat16)
    bufs = [torch.randn(b, skv + pad, n, h, device="cuda", generator=g).to(torch.bfloat16) for _ in range(2)]
    for buf in bufs:
        buf[:, skv:] = 3e4
    k, v = (buf[:, :skv] for buf in bufs)
    before = (flash_forward.launches, sage_forward.launches)
    out = attention_dispatch(q, k, v, provider=provider)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and out.shape == (b, sq, n, h)
    if provider == "auto":
        assert (flash_forward.launches, sage_forward.launches) == (before[0] + 1, before[1])
        ref, ref_lse = flash_attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        err = (out.transpose(1, 2).float() - ref.float()).abs()
        assert (err / ref.float().abs().clamp_min(1.0)).max().item() <= 2e-2
        _, lse = flash_forward(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        assert (lse - ref_lse).abs().max().item() <= 1e-2
    else:
        assert (flash_forward.launches, sage_forward.launches) == (before[0], before[1] + 1)
        lens = torch.full((b,), skv, dtype=torch.int32, device="cuda")
        codes = sage_prep(q, k, lens)
        ref = sage_attention_reference(*codes, v.transpose(1, 2), lens)
        _assert_k6_close(out.transpose(1, 2), ref, provider)
        # The last query tile's 120 rows on their own.
        _assert_k6_close(out.transpose(1, 2)[:, :, 256:], ref[:, :, 256:], (provider, "last q tile"))


@pytest.mark.gpu
def test_k1_k2_k3_at_40_heads_with_a_120_row_last_tile():
    """K1, the pre-pass, K2 and K3 at N=40, H=128 (Wan I2V-14B's heads) where
    Sq = Skv = 1016 = 7 * 128 + 120, the last tile's fill at 81x480x832
    (32,760 tokens), with shared Wan-style tables: against
    `flash_attention_reference` and `flash_backward_reference`, with the bounds
    of `test_k1_k2_k3_ragged_last_tile_at_h128`, the last tile's rows also on
    their own. Each input is a view into a buffer whose rows past the sequence
    hold 3e4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(32)
    b, n, s, h, pad = 1, 40, 1016, 128, 8
    bufs = [torch.randn(b, s + pad, n, h, device="cuda", generator=g).to(torch.bfloat16) for _ in range(4)]
    for buf in bufs:
        buf[:, s:] = 3e4
    q, k, v, do = (buf[:, :s].transpose(1, 2) for buf in bufs)
    cos, sin = _tables("shared", n, s, h, g)
    out, lse = flash_forward(q, k, v, None, cos, sin)
    ref, ref_lse = flash_attention_reference(q, k, v, None, cos, sin)
    torch.cuda.synchronize()
    for rows in (slice(None), slice(896, None)):
        err = (out[:, :, rows].float() - ref[:, :, rows].float()).abs()
        assert torch.isfinite(out).all() and (err / ref[:, :, rows].float().abs().clamp_min(1.0)).max() <= 2e-2
        assert (lse[:, :, rows] - ref_lse[:, :, rows]).abs().max().item() <= 1e-2
    grads = flash_backward(q, k, v, out, lse, do, None, cos, sin)
    refs = flash_backward_reference(q, k, v, out, lse, do, None, cos, sin)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(got).all(), name
        for rows in (slice(None), slice(896, None)):
            rel_l2, max_ratio = _rel_errors(got[:, :, rows], want[:, :, rows])
            assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (name, rows, rel_l2, max_ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [5, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_linear_on_the_card_matches_the_cpu(dtype, rows):
    """`int8_linear`'s forward and dx through `torch._int_mm` on the card (rows
    padded to 17 below it) against the same call on the CPU: the int32 products
    are exact on both, so the outputs agree to the epilogue's rounding (one unit
    in the last place of the output dtype)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from finetrainers_tpu_torch.ops.int8_linear import int8_linear, quantize_weight

    g = torch.Generator().manual_seed(3)
    x = torch.randn(rows, 640, generator=g).to(dtype)
    dy = torch.randn(rows, 1280, generator=g).to(dtype)
    wq, sw = quantize_weight(torch.randn(1280, 640, generator=g) * 0.03)
    results = []
    for device in ("cpu", "cuda"):
        leaf = x.detach().to(device).requires_grad_()
        y = int8_linear(leaf, wq.to(device), sw.to(device))
        y.backward(dy.to(device))
        results.append((y.detach().cpu().float(), leaf.grad.cpu().float()))
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-22
    for got, ref in zip(results[1], results[0]):
        assert ((got - ref).abs() <= ulp * ref.abs().clamp_min(1e-3)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,kv_heads,kind", [(128, 2, "causal_padding"), (64, 4, "causal"),
                                                    (128, 4, "block_sparse"), (64, 4, "block_sparse")])
def test_k1_mask_branch_matches_its_plain_version(head_dim, kv_heads, kind):
    """K1's mask branch through `attention_dispatch` (`auto`: the GQA repeat, the
    pre-pass, the branch) against its plain version on the same bf16 inputs:
    one launch, rows with a live key within K1's tolerance, an empty row 0 with
    an LSE of -1e30*ln2, and k and v rows of a skipped key tile never read."""
    from finetrainers_tpu_torch.ops.flash_attention import (flash_attention_masked_reference, flash_forward_masked,
                                                             flash_forward_masked_core, flash_qk_prep)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(head_dim + kv_heads)
    b, n, sq, skv = 2, 4, 333, 300
    q = torch.randn(b, sq, n, head_dim, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, skv, kv_heads, head_dim, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    mask = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril(skv - sq)[None].repeat(b, 1, 1)
    if kind == "causal_padding":
        mask &= (torch.arange(skv, device="cuda") < torch.tensor([[120], [300]], device="cuda"))[:, None]
    elif kind == "block_sparse":
        mask = torch.rand(b, sq, skv, generator=g, device="cuda") > 0.5
        mask[:, :, 128:256] = False
        mask[0, 9] = False
    launches = flash_forward_masked.launches
    out = attention_dispatch(q, k, v, attn_mask=mask[:, None], scale=head_dim**-0.5)
    assert flash_forward_masked.launches == launches + 1
    kb, vb = (x.repeat_interleave(n // kv_heads, dim=2).transpose(1, 2) for x in (k, v))
    ref, ref_lse = flash_attention_masked_reference(q.transpose(1, 2), kb, vb, mask)
    live = mask.any(-1)[:, None, :, None].expand(b, n, sq, head_dim)
    err = (out.transpose(1, 2).float() - ref.float()).abs()
    assert (err / ref.float().abs().clamp_min(1.0))[live].max() <= 2e-2
    q_s, k_r = flash_qk_prep(q.transpose(1, 2), kb, None, None, 0, head_dim**-0.5)
    core, lse = flash_forward_masked_core(q_s, k_r, vb, mask)
    assert (lse - ref_lse).abs()[live[..., 0]].max() <= 1e-2
    if kind == "block_sparse":
        assert not core[0, :, 9].any() and (lse[0, :, 9] == torch.tensor(-1e30 * 0.6931471805599453)).all()
        big_k, big_v = k_r.clone(), vb.clone()
        big_k[:, :, 128:256], big_v[:, :, 128:256] = 3e4, -3e4
        big = flash_forward_masked_core(q_s, big_k, big_v, mask)
        assert torch.equal(big[0], core) and torch.equal(big[1], lse)


# (name, B, N, Sq, Skv, branch, kv_lens, rope): K1's, K2's and K3's causal, segment and mask branches at
# lengths off every tile boundary, Sq < Skv and Sq > Skv for the causal offset (rows with no key), a key tile
# split over CTAs (few keys), kv_lens, fused RoPE, and rows with no live key under the mask.
BRANCH_CASES = [
    ("causal_self", 2, 3, 333, 333, "causal", None, "shared"),
    ("causal_q_short", 1, 2, 150, 700, "causal", [650], None),
    ("causal_q_long", 1, 2, 500, 200, "causal", None, None),
    ("segment_packed", 2, 2, 400, 400, "segment", [390, 400], "shared"),
    ("segment_cross_split", 1, 2, 900, 150, "segment", None, None),
    ("mask_sparse", 2, 2, 300, 450, "mask", [420, 450], None),
    ("mask_rope_split", 1, 2, 1000, 1000, "mask", None, "per_head"),
]


def _branch_inputs(branch, b, sq, skv, g):
    """The branch's flag, ids and mask: packed ids with -1 padding, a random
    block-sparse mask with a key tile off for every row and two empty rows."""
    causal, q_seg, kv_seg, mask = branch == "causal", None, None, None
    if branch == "segment":
        bounds = torch.randint(1, 6, (b, sq), generator=g, device="cuda").cumsum(-1) // 97
        q_seg = bounds.to(torch.int32)
        q_seg[:, -13:] = -1
        kv_seg = q_seg if sq == skv else (torch.arange(skv, device="cuda") // 50).to(torch.int32)[None].repeat(b, 1)
    if branch == "mask":
        mask = torch.rand(b, sq, skv, generator=g, device="cuda") > 0.4
        mask[:, :, 128:256] = False
        mask[:, 7] = False
        mask[-1, sq - 1] = False
    return causal, q_seg, kv_seg, mask


@pytest.mark.gpu
@pytest.mark.parametrize("case", BRANCH_CASES, ids=[c[0] for c in BRANCH_CASES])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k2_k3_branches_match_their_plain_versions(dtype, head_dim, case):
    """K1's, K2's and K3's causal, segment and mask branches (through
    `flash_forward` and `flash_backward`, the pre-pass included) against
    `flash_attention_reference` and `flash_backward_reference` with the same
    branch inputs: out within 2e-2 of max(1, |ref|) and the LSE within 1e-2
    on rows with a live key, rows without one exactly 0 (out, dq); dq, dk, dv
    within 1e-2 relative L2 and 2e-2 of max |ref|; each call launches its
    branch once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    name, b, n, sq, skv, branch, lens, rope = case
    g = torch.Generator(device="cuda").manual_seed(len(name))
    q, k, v = (torch.randn(b, s, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
               for s in (sq, skv, skv))
    do = torch.randn(b, sq, n, head_dim, device="cuda", generator=g).to(dtype).transpose(1, 2)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    cos, sin = _tables(rope, n, sq, head_dim, g)
    causal, q_seg, kv_seg, mask = _branch_inputs(branch, b, sq, skv, g)
    branches = (causal, q_seg, kv_seg, mask)
    before = [dict(getattr(fn, "branch_launches", {})) for fn in (flash_forward, flash_bwd_dkdv, flash_bwd_dq)]
    out, lse = flash_forward(q, k, v, kv_lens, cos, sin, None, *branches)
    dq, dk, dv = flash_backward(q, k, v, out, lse, do, kv_lens, cos, sin, None, None, *branches)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_reference(q, k, v, kv_lens, cos, sin, None, *branches)
    live = flash_attention_reference(q[..., :1], k[..., :1], v[..., :1].float(), kv_lens, None, None, None,
                                     *branches)[1] > -1e29  # (B, N, Sq): rows with a live key
    err = (out.float() - ref.float()).abs()[live]
    assert (err / ref.float().abs()[live].clamp_min(1.0)).max() <= 2e-2, (case, err.max())
    assert (lse - ref_lse).abs()[live].max() <= 1e-2, case
    assert not out[~live].any() and not dq[~live].any(), case
    refs = flash_backward_reference(q, k, v, out, lse, do, kv_lens, cos, sin, None, None, *branches)
    for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all(), (gname, case)
        rel_l2, max_ratio = _rel_errors(got, want)
        assert rel_l2 <= 1e-2 and max_ratio <= 2e-2, (gname, case, rel_l2, max_ratio)
    key = branch if branch != "mask" else None
    if key is not None:
        assert flash_forward.branch_launches[key] == before[0][key] + 1
    assert flash_bwd_dkdv.branch_launches[branch] == before[1][branch] + 1
    assert flash_bwd_dq.branch_launches[branch] == before[2][branch] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
def test_mask_branches_never_read_dead_key_tiles(head_dim):
    """Keys no query attends (a 128-key tile off for every row): their k and v
    rows filled with large values leave out, LSE, dq and the other keys' dk
    and dv bit-equal, and their own dk and dv are exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    b, n, sq, skv = 1, 2, 400, 640
    q, k, v, do = (torch.randn(b, n, s, head_dim, device="cuda", generator=g).to(torch.bfloat16)
                   for s in (sq, skv, skv, sq))
    mask = torch.rand(b, sq, skv, generator=g, device="cuda") > 0.5
    mask[:, :, 256:512] = False
    results = []
    for fill in (None, 3e4):
        kk, vv = k.clone(), v.clone()
        if fill is not None:
            kk[:, :, 256:512], vv[:, :, 256:512] = fill, -fill
        out, lse = flash_forward(q, kk, vv, mask=mask)
        results.append((out, lse, *flash_backward(q, kk, vv, out, lse, do, mask=mask)))
    (out, lse, dq, dk, dv), big = results
    assert all(torch.equal(x, y) for x, y in zip((out, lse, dq), big[:3]))
    for x, y in zip((dk, dv), big[3:]):
        assert torch.equal(x[:, :, :256], y[:, :, :256]) and torch.equal(x[:, :, 512:], y[:, :, 512:])
        assert not y[:, :, 256:512].any()


@pytest.mark.gpu
def test_attention_dispatch_takes_is_causal_flex_and_flash_varlen_on_the_card():
    """On a CUDA tensor `auto` and `flash` take `is_causal` through the causal
    branches, `flex` a mask without a head axis through the mask branches (a
    head-dependent one raises) and segment ids route to `flash_varlen`; each
    equals `_native_math` (bf16 tolerances)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(2, 300, 4, 128, device="cuda", generator=g).to(torch.bfloat16) for _ in range(3))
    mask = torch.rand(2, 1, 300, 300, generator=g, device="cuda") > 0.3
    mask[..., 0] = True
    ids = (torch.arange(300, device="cuda") // 120).to(torch.int32)[None].repeat(2, 1)
    seg_mask = (ids[:, None, :, None] == ids[:, None, None, :])
    for kwargs, ref_kwargs in ((dict(is_causal=True, provider="auto"), dict(is_causal=True)),
                               (dict(is_causal=True, provider="flash"), dict(is_causal=True)),
                               (dict(attn_mask=mask, provider="flex"), dict(attn_mask=mask)),
                               (dict(q_segment_ids=ids, kv_segment_ids=ids), dict(attn_mask=seg_mask))):
        out = attention_dispatch(q, k, v, **kwargs)
        ref = attention_dispatch(q, k, v, provider="_native_math", **ref_kwargs)
        assert (out.float() - ref.float()).abs().max() <= 2e-2, kwargs.get("provider")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention_dispatch(q, k, v, attn_mask=mask.expand(2, 4, 300, 300), provider="flex")


def _chip_smoke():
    """`chip_smoke.py` at the repo's root, imported once (it imports no JAX)."""
    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("branch", ["causal", "segment", "mask"])
def test_k2_k3_branches_select_exactly_the_live_pairs(branch, head_dim):
    """K2's and K3's branch selects pair by pair (`chip_smoke.branch_pair_errors`
    over its PAIR_CASES of this branch): ds at every (q row, key) pair, and each
    key's count of live q rows through p, equal to `live_pairs`. The gradient
    bounds of the tests above would let a few dropped pairs through."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    smoke = _chip_smoke()
    for name, b, n, sq, skv, case_branch, lens in smoke.PAIR_CASES:
        if case_branch == branch:
            wrong = smoke.branch_pair_errors(b, n, sq, skv, head_dim, branch, lens)
            assert not any(wrong.values()), (name, wrong)
