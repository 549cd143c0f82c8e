"""Flash attention forward (K1) on the H100, beside its plain PyTorch version.

Counterpart of `finetrainers_tpu/ops/flash_attention.py`: the Pallas
`_fwd_kernel` becomes the CUDA kernel in `csrc/flash_fwd.cu`, built by
`ops/_build.py`. Only the forward is ported; the backward kernels (K2, K3) and
the autograd glue come with the training slice (see ROADMAP.md).

  - `flash_forward(q, k, v, ...)` works on BNSH tensors and returns
    `(out, lse)`, like `_flash_forward`. On a CUDA tensor it launches the
    kernel, after checking device, dtype, shape and strides, or raises; on a
    CPU tensor it computes `flash_attention_reference`.
  - `flash_attention(query, key, value, ...)` is the BTNH interface of the JAX
    package's `flash_attention`, including its RoPE table conventions.
  - `flash_attention_reference` is the plain fp32 math of the kernel: the same
    base-2 softmax, cast points, masking and natural-log LSE.

`flash_forward.launches` counts kernel launches (never reference calls), so a
run can show that its attention went through the kernel.
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


def _rope_fwd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation (`_rope_fwd`): out[2i] = c*x[2i] - s*x[2i+1];
    out[2i+1] = c*x[2i+1] + s*x[2i]."""
    pairs = x.unflatten(-1, (-1, 2))
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos + rotated * sin


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
    kv_len = k.shape[2]
    scale = head_dim**-0.5 if scale is None else scale
    qf, kf = q.float(), k.float()
    if rope_cos is not None:
        qf = _rope_fwd(qf, rope_cos, rope_sin)
        kf = _rope_fwd(kf, rope_cos, rope_sin)
    qf = (qf * (scale * _LOG2E)).to(q.dtype).float()
    kf = kf.to(k.dtype).float()
    s = qf @ kf.transpose(-1, -2)  # base-2 logits
    if kv_lens is None:
        lens = torch.full((batch,), kv_len, device=q.device)
    else:
        lens = kv_lens.to(q.device).clamp(0, kv_len)
    valid = (torch.arange(kv_len, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (p @ v.float()) / l_safe
    lse = (m * _LN2 + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def _kernel():
    lib = load_library("flash_fwd")
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 6
        + [ctypes.c_int64] * 13
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


def _check_operand(name: str, x: torch.Tensor, device: torch.device, dtype: torch.dtype) -> None:
    if x.device != device:
        raise ValueError(f"flash_forward: {name} is on {x.device}, q is on {device}")
    if x.dtype != dtype:
        raise ValueError(f"flash_forward: {name} is {x.dtype}, q is {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"flash_forward: {name} must be contiguous in its last dim, strides {x.stride()}")
    if any(st % 8 for st in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"flash_forward: {name} needs 16-byte aligned rows (strides {x.stride()})")


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
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_forward: the kernel takes bf16 or fp16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_forward: q, k, v must be (B, N, S, H)")
    batch, heads, seq_q, head_dim = q.shape
    seq_kv = k.shape[2]
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash_forward: head dim {head_dim} not in {_HEAD_DIMS}")
    if tuple(k.shape) != (batch, heads, seq_kv, head_dim) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_forward: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device, q.dtype)
    if kv_lens is not None:
        if tuple(kv_lens.shape) != (batch,) or kv_lens.device != q.device:
            raise ValueError(f"flash_forward: kv_lens must be ({batch},) on {q.device}")
        kv_lens = kv_lens.to(torch.int32).contiguous()
    rope_sn = 0
    if rope_cos is not None:
        if seq_q != seq_kv:
            raise ValueError("flash_forward: fused RoPE needs self-attention shapes (Sq == Skv)")
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device
                    or t.ndim != 3 or t.shape[0] not in (1, heads) or tuple(t.shape[1:]) != (seq_q, head_dim)):
                raise ValueError(
                    f"flash_forward: {name} must be contiguous fp32 (N or 1, S, H) on {q.device}, "
                    f"got {tuple(t.shape)} {t.dtype}"
                )
        if rope_sin.shape != rope_cos.shape:
            raise ValueError("flash_forward: rope_cos and rope_sin shapes differ")
        rope_sn = 0 if rope_cos.shape[0] == 1 else seq_q * head_dim
    scale = head_dim**-0.5 if scale is None else float(scale)

    out = torch.empty((batch, seq_q, heads, head_dim), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            kv_lens.data_ptr() if kv_lens is not None else None,
            rope_cos.data_ptr() if rope_cos is not None else None,
            rope_sin.data_ptr() if rope_sin is not None else None,
            batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            rope_sn, scale * _LOG2E, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention on BTNH tensors (forward only).

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
    out, _ = flash_forward(query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2), kv_lens=kv_lens,
                           rope_cos=rope_cos, rope_sin=rope_sin, scale=scale)
    return out.transpose(1, 2)
