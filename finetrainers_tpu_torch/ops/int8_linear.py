"""int8 frozen-weight linear (port of `finetrainers_tpu/ops/int8_linear.py`).

A weight stored int8 with per-output-channel fp32 scales runs both its
forward and its input-gradient product as int8 x int8 -> int32 GEMMs:

    y  = (x_q @ W_q^T) * s_x * s_w            (forward, :59-71)
    dx = ((dy * s_w)_q @ W_q) * s_dy          (backward, :74-90; W is frozen: no wgrad)

with symmetric per-row dynamic quantization of the activations and of the
cotangent (`quantize_rows`, rounding half to even as `jnp.round` does) and
the dequant epilogue in the output dtype, as JAX forms it. The JAX package
runs the products as an XLA `dot_general` with an int32 result (not a
Pallas kernel); here they are `torch._int_mm` (cuBLASLt on the card, the
CPU's own on a CPU tensor). Each product is exact in int32, so the card and
the CPU agree on it bit for bit.

Layouts are torch's: the weight (F, K) with its scales (F,), the transpose
of JAX's (K, F) kernel, so a code here is JAX's code at the transposed
position. `torch._int_mm` on the card wants more than 16 rows and both
other dims multiples of 8, its second operand column-major; rows and
columns are padded with zeros where they fall short (a zero adds nothing
to an integer sum). The backward's second operand is W_q itself, so it
takes a transposed copy of W_q for the call, freed with it (PERF.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_MIN_ROWS = 17  # torch._int_mm on the card: more than 16 rows


def absmax_scale(absmax: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """max(absmax, eps) / 127 in fp32, a true division on every device (CUDA
    turns a division by a Python scalar into a multiplication by its
    reciprocal, which can move the scale by an ulp and a code across its
    rounding boundary), so the card's codes are the CPU's and JAX's."""
    absmax = absmax.clamp_min(eps)
    return absmax / torch.full_like(absmax, 127.0)


def quantize_rows(x: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last-dim) int8 quantization, x ~= x_q * s[..., None]
    (`quantize_rows`, :38-47): fp32 absmax and divide, round half to even,
    clip to [-127, 127]. Returns (x_q int8, s fp32 (..., 1))."""
    x32 = x.float()
    s = absmax_scale(x32.abs().amax(dim=-1, keepdim=True), eps)
    return torch.round(x32 / s).clamp(-127.0, 127.0).to(torch.int8), s


def quantize_weight(w: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel scales of a torch-layout weight w (F, K): w ~= w_q *
    s_w[:, None] (`quantize_weight`, :50-56, on JAX's transpose). Returns
    (w_q int8 (F, K), s_w fp32 (F,))."""
    w32 = w.float()
    s = absmax_scale(w32.abs().amax(dim=1), eps)
    return torch.round(w32 / s[:, None]).clamp(-127.0, 127.0).to(torch.int8), s


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b_t (N, K)^T int8 -> (M, N) int32 through `torch._int_mm`,
    with a's rows padded to 17 and K, N to multiples of 8 by zeros where they
    fall short; b_t is read as the column-major (K, N) operand."""
    m, k = a.shape
    n = b_t.shape[0]
    pm, pk, pn = max(m, _MIN_ROWS), _round_up(k, 8), _round_up(n, 8)
    if (pm, pk) != (m, k):
        a = F.pad(a, (0, pk - k, 0, pm - m))
    if (pn, pk) != (n, k):
        b_t = F.pad(b_t, (0, pk - k, 0, pn - n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    if a.is_cuda:
        int_mm.launches += 1
    return out[:m, :n] if (pm, pn) != (m, n) else out


int_mm.launches = 0  # the int8 GEMMs launched on the card (two per int8 layer and step: forward and dx)


def _forward_math(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    xq, sx = quantize_rows(x)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*x.shape[:-1], wq.shape[0])
    # Dequant epilogue in the output dtype (:66-71), as JAX rounds it.
    out = acc.to(x.dtype) * sx.to(x.dtype)
    return out * sw.to(x.dtype)


class Int8Linear(torch.autograd.Function):
    """`int8_linear` (the `jax.custom_vjp`, :59-93): the forward above; the
    backward gives dx only, dx = quant(dy * s_w) @ W_q in dy's dtype."""

    @staticmethod
    def forward(ctx, x, wq, sw):
        ctx.save_for_backward(wq, sw)
        return _forward_math(x, wq, sw)

    @staticmethod
    def backward(ctx, dy):
        wq, sw = ctx.saved_tensors
        dys = dy * sw.to(dy.dtype)
        dq, sdy = quantize_rows(dys)
        # dx (M, K) = dq (M, F) @ W_q (F, K): the second operand is W_q's transpose, copied for the call.
        acc = int_mm(dq.reshape(-1, dq.shape[-1]), wq.t().contiguous()).reshape(*dy.shape[:-1], wq.shape[1])
        return acc.to(dy.dtype) * sdy.to(dy.dtype), None, None


def int8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """y = dequant(quant(x) @ wq^T) in x's dtype. x (..., K); wq int8 (F, K);
    sw fp32 (F,)."""
    return Int8Linear.apply(x, wq, sw)
