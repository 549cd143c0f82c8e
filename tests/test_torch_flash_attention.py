"""K1 parity: the port's flash forward against the JAX Pallas kernel.

The JAX `flash_attention` / `_flash_forward` run the Pallas `_fwd_kernel` in
interpret mode on the CPU; the port's wrapper takes its plain PyTorch version
for CPU tensors. Same numpy inputs, fp32, compared on out and LSE at atol 2e-5,
rtol 1e-5 (fp32 sums in another order; the LSE of a row with no valid key is
-1e30*ln2 on both sides). The on-card check of the CUDA kernel against that
plain version is in `test_torch_kernels_gpu.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.ltx_video.transformer import LTXRotaryPosEmbed as JaxRope
from finetrainers_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from finetrainers_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from finetrainers_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_forward,
)

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5


def _ltx_tables(num_heads, head_dim, grid):
    """LTX full-inner-dim (S, N*H) tables; N*H % 6 != 0 puts identity slots first."""
    cos, sin = JaxRope(dim=num_heads * head_dim)(*grid, (0.32, 32.0, 32.0))
    return np.asarray(cos), np.asarray(sin)


def _shared_tables(seq, head_dim, rng):
    ang = rng.uniform(0, 2 * np.pi, (seq, head_dim // 2))
    return (np.repeat(np.cos(ang), 2, -1).astype(np.float32), np.repeat(np.sin(ang), 2, -1).astype(np.float32))


# name: (B, N, Sq, Skv, H, rope, kv_lens)
CASES = {
    "self_rope_full_inner_dim": (2, 2, 60, 60, 64, "ltx", None),
    "self_rope_shared_37": (1, 3, 37, 37, 64, "shared", None),
    "cross_kv_lens_with_zero": (3, 2, 40, 20, 64, None, [20, 7, 0]),
    "self_300_h128": (1, 2, 300, 300, 128, None, None),
    "self_rope_h128": (1, 2, 48, 48, 128, "ltx", None),
}


def _inputs(case):
    b, n, sq, skv, h, rope, lens = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q = rng.randn(b, sq, n, h).astype(np.float32)
    k = rng.randn(b, skv, n, h).astype(np.float32)
    v = rng.randn(b, skv, n, h).astype(np.float32)
    cos = sin = None
    if rope == "ltx":
        cos, sin = _ltx_tables(n, h, (3, 4, sq // 12))
    elif rope == "shared":
        cos, sin = _shared_tables(sq, h, rng)
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, kv_lens, cos, sin


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _bnsh_tables(cos, sin, n, h):
    """(S, N*H) -> (N, S, H) and (S, H) -> (1, S, H), as the JAX wrapper does."""
    if cos is None:
        return None, None
    if cos.shape[1] == h:
        return cos[None], sin[None]
    s = cos.shape[0]
    return (cos.reshape(s, n, h).transpose(1, 0, 2).copy(), sin.reshape(s, n, h).transpose(1, 0, 2).copy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax(case):
    q, k, v, kv_lens, cos, sin = _inputs(case)
    ref = jax_flash_attention(_j(q), _j(k), _j(v), kv_lens=_j(kv_lens), rope_cos=_j(cos), rope_sin=_j(sin))
    out = flash_attention(_t(q), _t(k), _t(v), kv_lens=_t(kv_lens), rope_cos=_t(cos), rope_sin=_t(sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_forward_out_and_lse_match_jax(case):
    q, k, v, kv_lens, cos, sin = _inputs(case)
    n, h = q.shape[2], q.shape[3]
    qb, kb, vb = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    cos_b, sin_b = _bnsh_tables(cos, sin, n, h)
    jax_lens = None if kv_lens is None else jnp.asarray(kv_lens)
    ref_out, ref_lse = jax_flash_forward(
        _j(qb), _j(kb), _j(vb), jax_lens, None, None, None, h**-0.5, False, 256, 256,
        rope_cos=_j(cos_b), rope_sin=_j(sin_b),
    )
    launches = flash_forward.launches
    out, lse = flash_forward(_t(qb), _t(kb), _t(vb), kv_lens=_t(kv_lens), rope_cos=_t(cos_b), rope_sin=_t(sin_b))
    assert flash_forward.launches == launches, "a CPU call must not count as a kernel launch"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL, rtol=RTOL)


def test_fully_masked_row_gives_zero_output():
    q, k, v, kv_lens, _, _ = _inputs("cross_kv_lens_with_zero")
    out, lse = flash_attention_reference(*(_t(x.transpose(0, 2, 1, 3).copy()) for x in (q, k, v)), kv_lens=_t(kv_lens))
    assert torch.all(out[2] == 0)
    assert torch.all(lse[2] == torch.tensor(-1e30 * 0.6931471805599453, dtype=torch.float32))


def test_wrapper_rejects_bad_rope_table_shape():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="rope tables"):
        flash_attention(q, q, q, rope_cos=torch.zeros(8, 64 * 3), rope_sin=torch.zeros(8, 64 * 3))
