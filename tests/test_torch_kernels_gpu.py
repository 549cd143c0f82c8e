"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: skips without a CUDA card (a CUDA kernel has no CPU mode). It
imports no JAX. On the card:

    python -m pytest tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch

from finetrainers_tpu_torch.ops import attention_dispatch
from finetrainers_tpu_torch.ops.flash_attention import flash_attention_reference, flash_forward

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
