"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: skips without a CUDA card (a CUDA kernel has no CPU mode). It
imports no JAX. On the card:

    python -m pytest tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch

from finetrainers_tpu_torch.ops import attention_dispatch, list_providers
from finetrainers_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction,
    flash_attention_reference,
    flash_backward,
    flash_backward_fused_reference,
    flash_backward_reference,
    flash_bwd_dkdv,
    flash_bwd_dq,
    flash_bwd_dq_emit,
    flash_bwd_fused,
    flash_bwd_prep,
    flash_forward,
    flash_forward_skew,
    flash_forward_skew_reference,
    flash_forward_two_level,
    flash_forward_two_level_reference,
    flash_forward_twopass,
    flash_forward_twopass_reference,
)
from finetrainers_tpu_torch.ops.sage_attention import sage_attention_reference, sage_forward, sage_quantize

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
        before = flash_forward.launches
        out, lse = flash_forward(q, k, v, kv_lens, cos, sin)
        torch.cuda.synchronize()
        assert flash_forward.launches == before + 1
        ref_out, ref_lse = flash_attention_reference(q, k, v, kv_lens, cos, sin)
        # bf16/fp16 output against an fp32 reference: about two units in the last place.
        torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


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
        before = (flash_bwd_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches)
        grads = flash_backward(q, k, v, out, lse, do, kv_lens, cos, sin)
        torch.cuda.synchronize()
        assert (flash_bwd_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches) == tuple(
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
    before = (flash_bwd_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches)
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
    assert (flash_bwd_prep.launches, flash_bwd_dkdv.launches, flash_bwd_dq.launches) == before


_VARIANTS = {
    "two_level": (flash_forward_two_level, flash_forward_two_level_reference),
    "twopass": (flash_forward_twopass, flash_forward_twopass_reference),
    "skew": (flash_forward_skew, flash_forward_skew_reference),
}


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_forward_variant_kernels_match_reference(variant, dtype):
    """K7a/b/c against their own plain versions and against K1's, with K1's
    bounds (the skewed kernel takes no RoPE tables: its cases drop them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    kernel, reference = _VARIANTS[variant]
    g = torch.Generator(device="cuda").manual_seed(5)
    for b, n, sq, skv, h, rope, lens in CASES:
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
        flash_forward(q, q, q, None, *((cos, sin) if tables else (None, None)))
        assert [c.launches - n for c, n in zip(counters, before)] == [int(c is launched) for c in counters], env
        monkeypatch.delenv(env)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_backward_kernel_matches_reference(dtype, monkeypatch):
    """K5 and its dq emit (after the pre-pass) against
    `flash_backward_fused_reference`, with K2/K3's bounds; K5 adds dq with
    atomics, so dq's fp32 sum order varies from run to run within them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("FINETRAINERS_FLASH_FUSED_BWD", "1")
    g = torch.Generator(device="cuda").manual_seed(6)
    for b, n, sq, skv, h, rope, lens in CASES:
        q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2)
                   for s in (sq, skv, skv))
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        cos, sin = _tables(rope, n, sq, h, g)
        out, lse = flash_forward(q, k, v, kv_lens, cos, sin)
        do = torch.randn(b, sq, n, h, device="cuda", generator=g).to(dtype).transpose(1, 2)
        counters = (flash_bwd_prep, flash_bwd_dkdv, flash_bwd_dq, flash_bwd_fused, flash_bwd_dq_emit)
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


# (B, N, Sq, Skv, H, kv_lens): Wan-like H=128 self-attention, cross-attention over
# padded text with few valid keys, LTX's H=64, lengths off every tile boundary, an empty row.
SAGE_CASES = [
    (2, 2, 300, 300, 128, None),
    (1, 3, 129, 520, 128, [9]),
    (2, 4, 256, 256, 64, None),
    (3, 2, 100, 77, 64, [77, 30, 0]),
]
SAGE_NAMES = ("sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda", "_sage_qk_int8_pv_fp16_triton",
              "_sage_qk_int8_pv_fp8_cuda", "_sage_qk_int8_pv_fp8_cuda_sm90")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sage_kernel_matches_reference(dtype):
    """K6 against `sage_attention_reference` on the same codes and scales. q/k/v
    are BNSH views of BTNH buffers and the codes come from the pre-pass on the
    card. Bound: |out - ref| <= 2e-2 * max(1, |ref|) elementwise and relative L2
    <= 1e-2 (the kernel rounds p to v's dtype before P V; the reference keeps
    it fp32); a row with no valid key gives exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    for b, n, sq, skv, h, lens in SAGE_CASES:
        q, k, v = (torch.randn(b, s, n, h, device="cuda", generator=g).to(dtype) for s in (sq, skv, skv))
        k = k + 1.5  # a channel offset, which smooth-K removes
        kv_lens = torch.tensor(lens if lens else [skv] * b, dtype=torch.int32, device="cuda")
        codes = sage_quantize(q, k, kv_lens)
        before = sage_forward.launches
        out = sage_forward(*codes, v.transpose(1, 2), kv_lens)
        torch.cuda.synchronize()
        assert sage_forward.launches == before + 1
        ref = sage_attention_reference(*codes, v.transpose(1, 2), kv_lens)
        assert out.dtype == dtype and out.shape == ref.shape
        err = (out.float() - ref.float()).abs()
        assert (err / ref.float().abs().clamp_min(1.0)).max().item() <= 2e-2, (b, n, sq, skv, h, lens)
        assert _rel_errors(out, ref)[0] <= 1e-2, (b, n, sq, skv, h, lens)
        if lens and 0 in lens:
            assert not out[lens.index(0)].any()


@pytest.mark.gpu
def test_sage_prepass_on_the_card_matches_the_cpu():
    """The pre-pass (torch ops) on the card against the same ops on the CPU:
    q codes and scales equal; the smoothed k's mean is summed in another order,
    so at most 0.1% of k codes may differ, by one."""
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
    """Each sage provider name launches K6 once for a bf16 call with a padding
    mask, and raises (launching nothing) for fp32, a causal call and a dense
    mask beside kv_lens: no sage name falls to plain math on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert set(SAGE_NAMES) <= set(list_providers())
    q = torch.randn(2, 40, 2, 64, device="cuda").to(torch.bfloat16)
    mask = (torch.arange(40, device="cuda")[None, :] < torch.tensor([[40], [11]], device="cuda"))[:, None, None, :]
    lens = torch.tensor([40, 11], dtype=torch.int32, device="cuda")
    for name in SAGE_NAMES:
        before = sage_forward.launches
        out = attention_dispatch(q, q, q, attn_mask=mask, provider=name)
        assert sage_forward.launches == before + 1 and out.shape == q.shape
        ref = attention_dispatch(q, q, q, kv_lens=lens, provider=name)
        assert torch.equal(out, ref)
        with pytest.raises(ValueError, match="bf16 or fp16"):
            attention_dispatch(q.float(), q.float(), q.float(), provider=name)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            attention_dispatch(q, q, q, is_causal=True, provider=name)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            attention_dispatch(q, q, q, attn_mask=mask, kv_lens=lens, provider=name)
        assert sage_forward.launches == before + 2
