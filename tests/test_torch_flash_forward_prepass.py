"""K1 as the port runs it: the pre-pass, then the core on its operands.

On a CUDA tensor `flash_forward` launches the pre-pass (`flash_qk_prep`: q_s =
T(rope(q) * scale * log2e), k_r = T(rope(k)), T() rounding to the input dtype)
and then K1 on q_s and k_r, which takes no tables and no scale of its own. Here
the plain versions of the two (`flash_qk_prep_reference`, then
`flash_forward_core_reference`) are held against the JAX `_flash_forward`,
whose Pallas `_fwd_kernel` rotates and scales per tile, in interpret mode on the
CPU. Same numpy inputs: H=64 with per-head tables, H=128 with one shared table
pair, no tables, kv_lens with an empty row, lengths off every 64- and 128-row
tile.

Tolerances: fp32 at atol 2e-5, rtol 1e-5 on out and LSE, as the existing K1
parity tests (fp32 sums in another order). bf16 at atol 1e-2, rtol 2e-2 on out
(a bf16 output is rounded to 8 bits of mantissa, and at H=64 the JAX kernel
exponentiates p in bf16 where the port keeps fp32) and atol 1e-2 on the fp32
LSE (its l sums those p). The composition must equal `flash_attention_reference`
bit for bit: that function is defined as the same two steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from finetrainers_tpu_torch.ops.flash_attention import (
    flash_attention_reference,
    flash_forward,
    flash_forward_core,
    flash_forward_core_reference,
    flash_qk_prep,
    flash_qk_prep_reference,
)

torch.set_num_threads(1)

# name: (B, N, Sq, Skv, H, tables, kv_lens); tables "per_head" is (N, S, H), "shared" (1, S, H).
CASES = {
    "h64_per_head_tables": (2, 2, 100, 100, 64, "per_head", None),
    "h64_per_head_tables_kv_lens": (2, 2, 90, 90, 64, "per_head", [90, 45]),
    "h128_shared_tables": (1, 3, 130, 130, 128, "shared", None),
    "h64_no_tables_kv_lens_with_zero": (3, 2, 70, 150, 64, None, [150, 33, 0]),
    "h128_no_tables_kv_lens_with_zero": (2, 2, 77, 200, 128, None, [0, 129]),
}
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# dtype -> (out atol, out rtol, LSE atol, LSE rtol); see the module docstring.
TOLS = {"fp32": (2e-5, 1e-5, 2e-5, 1e-5), "bf16": (1e-2, 2e-2, 1e-2, 0.0)}


def _inputs(case):
    """BNSH fp32 numpy q, k, v, the tables (or None) and kv_lens (or None)."""
    b, n, sq, skv, h, tables, lens = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q = rng.randn(b, n, sq, h).astype(np.float32)
    k, v = (rng.randn(b, n, skv, h).astype(np.float32) for _ in range(2))
    cos = sin = None
    if tables is not None:
        ang = rng.uniform(0, 2 * np.pi, (n if tables == "per_head" else 1, sq, h // 2))
        cos, sin = (np.repeat(f(ang), 2, -1).astype(np.float32) for f in (np.cos, np.sin))
    return q, k, v, cos, sin, None if lens is None else np.asarray(lens, np.int32)


def _torch(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _prepass_then_core(q, k, v, kv_lens, cos, sin):
    """The plain pre-pass, its operands rounded to the input dtype (they are
    already: the cast is exact), then the plain core."""
    q_s, k_r = flash_qk_prep_reference(q, k, cos, sin, q.shape[-1]**-0.5)
    return flash_forward_core_reference(q_s.to(q.dtype), k_r.to(k.dtype), v, kv_lens)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_prepass_then_core_matches_jax_flash_forward(case, dtype):
    q, k, v, cos, sin, lens = _inputs(case)
    t_dtype, j_dtype = DTYPES[dtype]
    h = q.shape[-1]
    ref_out, ref_lse = jax_flash_forward(
        *(jnp.asarray(x).astype(j_dtype) for x in (q, k, v)), None if lens is None else jnp.asarray(lens),
        None, None, None, h**-0.5, False, 64, 64,
        rope_cos=None if cos is None else jnp.asarray(cos), rope_sin=None if sin is None else jnp.asarray(sin),
    )
    out, lse = _prepass_then_core(*(_torch(x, t_dtype) for x in (q, k, v)), _torch(lens), _torch(cos), _torch(sin))
    assert out.dtype == t_dtype and out.shape == q.shape and lse.shape == q.shape[:3]
    atol, rtol, lse_atol, lse_rtol = TOLS[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_out.astype(jnp.float32)), atol=atol, rtol=rtol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=lse_atol, rtol=lse_rtol)
    if lens is not None and 0 in lens:
        empty = list(lens).index(0)
        assert not out[empty].any()
        assert torch.all(lse[empty] == torch.tensor(-1e30 * 0.6931471805599453, dtype=torch.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_prepass_then_core_is_flash_attention_reference(case, dtype):
    q, k, v, cos, sin, lens = _inputs(case)
    t_dtype = DTYPES[dtype][0]
    args = (*(_torch(x, t_dtype) for x in (q, k, v)), _torch(lens), _torch(cos), _torch(sin))
    out, lse = _prepass_then_core(*args)
    ref_out, ref_lse = flash_attention_reference(*args)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_cpu_wrappers_take_the_plain_versions_without_counting():
    """On CPU tensors `flash_forward` and `flash_forward_core` compute the plain
    versions and count no launch of the pre-pass or of K1."""
    q, k, v, cos, sin, lens = _inputs("h64_per_head_tables_kv_lens")
    q, k, v, cos, sin, lens = (_torch(x) for x in (q, k, v, cos, sin, lens))
    before = flash_qk_prep.launches, flash_forward.launches
    out, lse = flash_forward(q, k, v, lens, cos, sin)
    q_s, k_r = flash_qk_prep_reference(q, k, cos, sin, q.shape[-1]**-0.5)
    core_out, core_lse = flash_forward_core(q_s, k_r, v, lens)
    assert (flash_qk_prep.launches, flash_forward.launches) == before
    assert torch.equal(out, core_out) and torch.equal(lse, core_lse)
