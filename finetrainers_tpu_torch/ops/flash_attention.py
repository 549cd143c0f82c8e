"""Flash attention on the H100: K1 (forward), K2/K3 (backward) and the autograd
glue K4, each beside its plain PyTorch version.

Counterpart of `finetrainers_tpu/ops/flash_attention.py`: the Pallas
`_fwd_kernel` becomes the CUDA kernel in `csrc/flash_fwd.cu`; `_bwd_dkdv_kernel`
and `_bwd_dq_kernel` become the CUDA kernels in `csrc/flash_bwd.cu`, with a
pre-pass there that rotates and scales q and k once per call; all are built by
`ops/_build.py`.

  - `flash_forward(q, k, v, ...)` works on BNSH tensors and returns
    `(out, lse)`, like `_flash_forward`. On a CUDA tensor it launches K1,
    after checking device, dtype, shape and strides, or raises; on a CPU
    tensor it computes `flash_attention_reference`.
  - `flash_backward(q, k, v, out, lse, do, ...)` returns `(dq, dk, dv)`, like
    `_flash_backward`, from a caller-given LSE. On a CUDA tensor it launches
    the pre-pass, K2 and K3 after the same checks, or raises; on a CPU tensor
    it computes `flash_backward_reference`.
  - `FlashAttentionFunction` (K4) is the `torch.autograd.Function` joining
    them, the counterpart of the `jax.custom_vjp` `_flash_mha`.
  - `flash_attention(query, key, value, ...)` is the BTNH interface of the JAX
    package's `flash_attention`, including its RoPE table conventions; it goes
    through K4 on every device, so its backward is K2/K3 (or their plain
    version on the CPU), never autograd through the forward's math.
  - `flash_attention_reference` / `flash_backward_reference` are the plain
    fp32 math of the kernels: the same base-2 softmax, cast points, masking and
    natural-log LSE.

Each kernel wrapper keeps a `launches` count (`flash_forward`, `flash_bwd_prep`,
`flash_bwd_dkdv`, `flash_bwd_dq`) of kernel launches, never of reference calls,
so a run can show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import load_library

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """rotate(x)[2i] = -x[2i+1]; rotate(x)[2i+1] = x[2i]."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def _rope_fwd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation (`_rope_fwd`): out[2i] = c*x[2i] - s*x[2i+1];
    out[2i+1] = c*x[2i+1] + s*x[2i]."""
    return x * cos + _rotate_pairs(x) * sin


def _rope_bwd(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Transpose rotation (`_rope_bwd`): d(raw x) = g*cos - rotate(g)*sin."""
    return g * cos - _rotate_pairs(g) * sin


def _valid_keys(kv_lens: Optional[torch.Tensor], batch: int, kv_len: int, device) -> torch.Tensor:
    """(B, 1, 1, Skv) boolean: key j of batch b is attended iff j < kv_lens[b]."""
    if kv_lens is None:
        lens = torch.full((batch,), kv_len, device=device)
    else:
        lens = kv_lens.to(device).clamp(0, kv_len)
    return (torch.arange(kv_len, device=device)[None, :] < lens[:, None])[:, None, None, :]


def flash_bwd_prep_reference(q, k, rope_cos, rope_sin, scale):
    """Plain version of the backward's pre-pass (and of K1's own q/k
    preparation): q_s = T(rope(q) * scale * log2e) and k_r = T(rope(k)), where
    T() rounds to the input dtype, returned as fp32."""
    qf, kf = q.float(), k.float()
    if rope_cos is not None:
        qf = _rope_fwd(qf, rope_cos, rope_sin)
        kf = _rope_fwd(kf, rope_cos, rope_sin)
    return (qf * (scale * _LOG2E)).to(q.dtype).float(), kf.to(k.dtype).float()


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 version of K1. q: (B, N, Sq, H); k, v: (B, N, Skv, H);
    kv_lens: (B,) ints; rope tables: (N or 1, S, H) fp32. Returns out in q's
    dtype and the (B, N, Sq) fp32 natural-log LSE. Like the kernel, the rotated
    and scaled q and the rotated k are rounded to the input dtype before QK^T."""
    batch, _, _, head_dim = q.shape
    scale = head_dim**-0.5 if scale is None else scale
    qs, kr = flash_bwd_prep_reference(q, k, rope_cos, rope_sin, scale)
    s = qs @ kr.transpose(-1, -2)  # base-2 logits
    valid = _valid_keys(kv_lens, batch, k.shape[2], q.device)
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (p @ v.float()) / l_safe
    lse = (m * _LN2 + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain fp32 version of K2 and K3 (BNSH, shapes as `flash_forward`; lse
    natural-log (B, N, Sq) fp32). Rounds where the kernels and `_flash_backward`
    round: q_s and k_r as in the forward; p to the input dtype before the dv
    product; ds = T(p * T(dp - delta)); delta = rowsum(dO * out) in fp32 over
    the rounded `out` unless given; dk = rope^T(ln2 * ds^T q_s) and
    dq = rope^T(scale * ds k_r) in fp32, then rounded. Masked keys are selected
    to p = 0 (a row with no valid key has an LSE of -1e30*ln2, where exp2
    overflows). Returns (dq, dk, dv) in the input dtypes."""
    batch, _, _, head_dim = q.shape
    scale = head_dim**-0.5 if scale is None else scale
    dtype = q.dtype
    qs, kr = flash_bwd_prep_reference(q, k, rope_cos, rope_sin, scale)
    dof = do.float()
    if delta is None:
        delta = (dof * out.float()).sum(-1)
    s = qs @ kr.transpose(-1, -2)
    p = torch.exp2(s - (lse * _LOG2E)[..., None]).to(dtype).float()
    p = torch.where(_valid_keys(kv_lens, batch, k.shape[2], q.device), p, torch.zeros_like(p))
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta[..., None]).to(dtype).float()).to(dtype).float()
    dk = (ds.transpose(-1, -2) @ qs) * _LN2
    dq = (ds @ kr) * scale
    if rope_cos is not None:
        dk = _rope_bwd(dk, rope_cos, rope_sin)
        dq = _rope_bwd(dq, rope_cos, rope_sin)
    return dq.to(dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel(library: str, fn_name: str, argtypes):
    fn = getattr(load_library(library), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _btnh_like(x: torch.Tensor) -> torch.Tensor:
    """An empty BNSH tensor shaped like `x`, viewing a BTNH-contiguous buffer."""
    b, n, s, h = x.shape
    return torch.empty((b, s, n, h), dtype=x.dtype, device=x.device).transpose(1, 2)


def _strides(*xs: torch.Tensor):
    vals = [st for x in xs for st in x.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _kernel_layout(x: torch.Tensor) -> bool:
    """Whether the kernels can read `x` as it lies: last dim contiguous, every
    row 16-byte aligned."""
    return x.stride(-1) == 1 and not any(st % 8 for st in x.stride()[:-1]) and x.data_ptr() % 16 == 0


def _check_operand(fn: str, name: str, x: torch.Tensor, device: torch.device, dtype: torch.dtype) -> None:
    if x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, q is on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {x.dtype}, q is {dtype}")
    if not _kernel_layout(x):
        raise ValueError(f"{fn}: {name} must be contiguous in its last dim with 16-byte aligned rows "
                         f"(strides {x.stride()})")


def _check_kernel_call(fn: str, q, k, v, kv_lens, rope_cos, rope_sin):
    """The checks K1, K2 and K3 share. Returns kv_lens as contiguous int32 (or
    None) and the tables' per-head stride (0 for one table shared by every head)."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: the kernel takes bf16 or fp16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{fn}: q, k, v must be (B, N, S, H)")
    batch, heads, seq_q, head_dim = q.shape
    seq_kv = k.shape[2]
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {head_dim} not in {_HEAD_DIMS}")
    if tuple(k.shape) != (batch, heads, seq_kv, head_dim) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(fn, name, x, q.device, q.dtype)
    if kv_lens is not None:
        if tuple(kv_lens.shape) != (batch,) or kv_lens.device != q.device:
            raise ValueError(f"{fn}: kv_lens must be ({batch},) on {q.device}")
        kv_lens = kv_lens.to(torch.int32).contiguous()
    rope_sn = 0
    if rope_cos is not None:
        if seq_q != seq_kv:
            raise ValueError(f"{fn}: fused RoPE needs self-attention shapes (Sq == Skv)")
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16
                    or t.ndim != 3 or t.shape[0] not in (1, heads) or tuple(t.shape[1:]) != (seq_q, head_dim)):
                raise ValueError(
                    f"{fn}: {name} must be contiguous, 16-byte aligned fp32 (N or 1, S, H) on {q.device}, "
                    f"got {tuple(t.shape)} {t.dtype}"
                )
        if rope_sin.shape != rope_cos.shape:
            raise ValueError(f"{fn}: rope_cos and rope_sin shapes differ")
        rope_sn = 0 if rope_cos.shape[0] == 1 else seq_q * head_dim
    return kv_lens, rope_sn


def flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on BNSH tensors -> (out (B, N, Sq, H) in q's dtype, lse (B, N, Sq) fp32).

    The kernel takes bf16 or fp16 with H in {64, 128} and any sequence lengths;
    fused RoPE needs Sq == Skv and (N or 1, S, H) fp32 tables. `out` is a BNSH
    view of a BTNH-contiguous buffer, so `out.transpose(1, 2)` is contiguous."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_lens, rope_cos, rope_sin, scale)
    kv_lens, rope_sn = _check_kernel_call("flash_forward", q, k, v, kv_lens, rope_cos, rope_sin)
    batch, heads, seq_q, head_dim = q.shape
    seq_kv = k.shape[2]
    scale = head_dim**-0.5 if scale is None else float(scale)

    out = _btnh_like(q)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device)
    fn = _kernel("flash_fwd", "flash_fwd",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 13 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        _launch(
            fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin),
            batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            rope_sn, scale * _LOG2E, _stream(q.device),
        )
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_bwd_prep(q, k, rope_cos, rope_sin, rope_sn: int, scale: float):
    """The backward's pre-pass, on operands `flash_backward` has checked:
    q_s = T(rope(q) * scale * log2e) and, with tables, k_r = T(rope(k)), both
    (B, N, S, H) contiguous. Without tables k_r is k itself."""
    batch, heads, seq_q, head_dim = q.shape
    q_s = torch.empty((batch, heads, seq_q, head_dim), dtype=q.dtype, device=q.device)
    k_r = k if rope_cos is None else torch.empty(k.shape, dtype=k.dtype, device=k.device)
    fn = _kernel("flash_bwd", "flash_bwd_prep",
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 7 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        _launch(
            fn, q.data_ptr(), k.data_ptr(), q_s.data_ptr(), None if rope_cos is None else k_r.data_ptr(),
            _ptr(rope_cos), _ptr(rope_sin), batch, heads, seq_q, k.shape[2], head_dim, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], rope_sn, scale * _LOG2E, _stream(q.device),
        )
    flash_bwd_prep.launches += 1
    return q_s, k_r


flash_bwd_prep.launches = 0

_BWD_ARGTYPES = [ctypes.c_void_p] * 9


def flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int):
    """K2 on operands `flash_backward` has checked, with q_s/k_r from
    `flash_bwd_prep`: (dk, dv), BNSH views of BTNH-contiguous buffers."""
    batch, heads, seq_q, head_dim = q_s.shape
    dk, dv = _btnh_like(k_r), _btnh_like(v)
    fn = _kernel("flash_bwd", "flash_bwd_dkdv",
                 _BWD_ARGTYPES + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_void_p])
    strides = _strides(q_s, k_r, v, do, dk, dv)
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin), dk.data_ptr(), dv.data_ptr(),
            batch, heads, seq_q, k_r.shape[2], head_dim, _DTYPE_CODES[q_s.dtype], strides, rope_sn,
            _stream(q_s.device),
        )
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int, scale: float):
    """K3 on operands `flash_backward` has checked, with q_s/k_r from
    `flash_bwd_prep`: dq, a BNSH view of a BTNH-contiguous buffer."""
    batch, heads, seq_q, head_dim = q_s.shape
    dq = _btnh_like(q_s)
    fn = _kernel("flash_bwd", "flash_bwd_dq",
                 _BWD_ARGTYPES + [ctypes.c_void_p] + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_float, ctypes.c_void_p])
    strides = _strides(q_s, k_r, v, do, dq)
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin), dq.data_ptr(),
            batch, heads, seq_q, k_r.shape[2], head_dim, _DTYPE_CODES[q_s.dtype], strides, rope_sn, scale,
            _stream(q_s.device),
        )
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 and K3 on BNSH tensors -> (dq, dk, dv), from the forward's `out`, a
    caller-given natural-log `lse` (B, N, Sq) fp32 and the output gradient `do`.

    Takes what K1 takes (bf16/fp16, H in {64, 128}, any sequence lengths,
    `kv_lens`, fused RoPE from (N or 1, S, H) fp32 tables with Sq == Skv).
    delta = rowsum(dO * out) in fp32 is computed here in plain PyTorch unless
    given. dq, dk, dv are BNSH views of BTNH-contiguous buffers."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, do, kv_lens, rope_cos, rope_sin, scale, delta)
    kv_lens, rope_sn = _check_kernel_call("flash_backward", q, k, v, kv_lens, rope_cos, rope_sin)
    if tuple(do.shape) != tuple(q.shape) or do.device != q.device or do.dtype != q.dtype:
        raise ValueError(f"flash_backward: do must match q, got {tuple(do.shape)} {do.dtype} on {do.device}")
    if not _kernel_layout(do):
        # Layout fix, not a fallback: the kernels read dO rows with 16-byte copies.
        do = do.contiguous()
    batch, heads, seq_q, head_dim = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (tuple(x.shape) != (batch, heads, seq_q) or x.dtype != torch.float32
                              or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"flash_backward: {name} must be contiguous fp32 ({batch}, {heads}, {seq_q}) "
                             f"on {q.device}")
    scale = head_dim**-0.5 if scale is None else float(scale)
    if delta is None:
        delta = (do.float() * out.float()).sum(-1)
    q_s, k_r = flash_bwd_prep(q, k, rope_cos, rope_sin, rope_sn, scale)
    dk, dv = flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn)
    dq = flash_bwd_dq(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn, scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """K4: flash attention with a kernel backward (the `jax.custom_vjp`
    `_flash_mha`). The forward is `flash_forward` and saves q, k, v, out and
    the LSE; the backward is `flash_backward` on them. BNSH tensors; kv_lens,
    the RoPE tables and the scale get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, rope_cos, rope_sin, scale):
        out, lse = flash_forward(q, k, v, kv_lens, rope_cos, rope_sin, scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens, rope_cos, rope_sin)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens, rope_cos, rope_sin = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, kv_lens, rope_cos, rope_sin, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention on BTNH tensors, differentiable through K4.

    query: (B, Sq, N, H); key/value: (B, Skv, N, H). rope_cos/rope_sin:
    optional fp32 tables for fused interleaved-pair RoPE, either (S, N*H)
    full-inner-dim (LTX) or (S, H) shared across heads; they need Sq == Skv."""
    batch, q_len, num_heads, head_dim = query.shape
    kv_len = key.shape[1]
    if rope_cos is not None:
        if q_len != kv_len:
            raise ValueError("fused RoPE requires self-attention shapes")
        if tuple(rope_cos.shape) == (q_len, num_heads * head_dim):
            rope_cos = rope_cos.reshape(q_len, num_heads, head_dim).transpose(0, 1).contiguous()
            rope_sin = rope_sin.reshape(q_len, num_heads, head_dim).transpose(0, 1).contiguous()
        elif tuple(rope_cos.shape) == (q_len, head_dim):
            rope_cos = rope_cos[None].contiguous()
            rope_sin = rope_sin[None].contiguous()
        else:
            raise ValueError(
                f"rope tables must be (S, N*H) or (S, H); got {tuple(rope_cos.shape)} "
                f"for S={q_len}, N={num_heads}, H={head_dim}"
            )
    scale = head_dim**-0.5 if scale is None else float(scale)
    out = FlashAttentionFunction.apply(query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2), kv_lens,
                                       rope_cos, rope_sin, scale)
    return out.transpose(1, 2)
