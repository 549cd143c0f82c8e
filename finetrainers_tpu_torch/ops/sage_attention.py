"""INT8 SageAttention on the H100: K6 beside its plain PyTorch version.

Counterpart of `finetrainers_tpu/ops/sage_attention.py`: the Pallas
`_sage_fwd_kernel` becomes the CUDA kernel in `csrc/sage_fwd.cu`, built by
`ops/_build.py`. Forward-only and meant for serving, as in the JAX package.

  - `sage_quantize(query, key, kv_lens)` is the quantization pre-pass, in
    torch ops as the JAX package computes it in XLA (`_sage_impl` :112-121):
    smooth-K (k minus its fp32 mean over the valid prefix, kept fp32 until it
    is quantized), then per-token int8 codes with absmax/127 scales.
  - `sage_attention_reference(...)` is the plain version of the kernel on the
    codes and scales: the Pallas kernel's arithmetic (:64-93), in blocks of q
    rows so that it also runs at Wan's 19968-token shape on the card.
  - `sage_forward(...)` launches K6 on CUDA tensors, after checking device,
    dtype, shape and strides, or raises; on CPU tensors it computes the plain
    version. It counts its kernel launches in `sage_forward.launches`.
  - `sage_attention(query, key, value, ...)` is the BTNH entry of the JAX
    package's `sage_attention`: kv_lens and scale defaults, GQA head repeat,
    pre-pass, then `sage_forward`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .flash_attention import (
    _DTYPE_CODES,
    _HEAD_DIMS,
    _LOG2E,
    _NEG_INF,
    _check_operand,
    _kernel,
    _launch,
    _ptr,
    _stream,
    _strides,
)

# Rows of q per block of the plain version: its fp32 score block is
# (block, Skv), 320 MB at Wan's 19968 keys.
_REFERENCE_BLOCK_Q = 4096


def quantize_per_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H) -> int8 codes and fp32 per-token scales (`_quantize_per_token`,
    :96-103): absmax/127, 1.0 where absmax is 0, round half to even."""
    x = x.float()
    absmax = x.abs().amax(dim=-1)
    # A 0-dim tensor divisor, not a Python scalar: on CUDA, PyTorch divides by
    # a scalar as a multiply by its reciprocal, one ulp off the IEEE quotient
    # that the CPU and XLA give.
    scales = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0), torch.ones_like(absmax))
    codes = torch.clamp(torch.round(x / scales[..., None]), -127, 127).to(torch.int8)
    return codes, scales


def smooth_k(key: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
    """BTNH k minus its fp32 per-(batch, head, channel) mean over the valid
    prefix (:112-118), divisor clamped to >= 1. Returns fp32: rounding the
    shifted k to its input dtype before quantization would add error."""
    kf = key.float()
    valid = torch.arange(key.shape[1], device=key.device)[None, :] < kv_lens[:, None]
    denom = kv_lens.float().clamp_min(1.0)[:, None, None, None]
    mean = torch.where(valid[:, :, None, None], kf, torch.zeros_like(kf)).sum(dim=1, keepdim=True) / denom
    return kf - mean


def sage_quantize(query: torch.Tensor, key: torch.Tensor, kv_lens: torch.Tensor):
    """The pre-pass on BTNH q and k -> (q_codes, k_codes, q_scales, k_scales):
    codes as (B, N, S, H) int8 views and scales as (B, N, S) fp32 views of
    BTNH-ordered buffers (the kernel takes strides, so nothing is transposed)."""
    q_codes, q_scales = quantize_per_token(query)
    k_codes, k_scales = quantize_per_token(smooth_k(key, kv_lens))
    return q_codes.transpose(1, 2), k_codes.transpose(1, 2), q_scales.transpose(1, 2), k_scales.transpose(1, 2)


def sage_attention_reference(
    q_codes: torch.Tensor,
    k_codes: torch.Tensor,
    q_scales: torch.Tensor,
    k_scales: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of K6 on BNSH codes (B, N, S, H) int8, scales (B, N, S)
    fp32 and v (B, N, Skv, H) -> out (B, N, Sq, H) in v's dtype.

    s = float(q8 k8^T) * (qs ks) * scale with natural exp; columns at or past
    kv_lens are selected to -1e30 before the row max and p to 0; p v in fp32;
    a row whose sum is 0 gives 0. The int32 products are exact in an fp32
    matmul (|sum| <= 127^2 * H < 2^24) as long as the matmul runs in full fp32
    (PyTorch's default; TF32 off)."""
    batch, heads, seq_q, head_dim = q_codes.shape
    seq_kv = k_codes.shape[2]
    scale = head_dim**-0.5 if scale is None else float(scale)
    lens = torch.full((batch,), seq_kv) if kv_lens is None else kv_lens.cpu().clamp(0, seq_kv)
    out = torch.empty((batch, heads, seq_q, head_dim), dtype=v.dtype, device=v.device)
    valid_cols = torch.arange(seq_kv, device=v.device)
    for b in range(batch):
        valid = valid_cols < int(lens[b])
        for n in range(heads):
            kf = k_codes[b, n].float()
            ks = k_scales[b, n]
            vf = v[b, n].float()
            for r0 in range(0, seq_q, _REFERENCE_BLOCK_Q):
                r1 = min(r0 + _REFERENCE_BLOCK_Q, seq_q)
                s32 = q_codes[b, n, r0:r1].float() @ kf.T
                s = s32 * (q_scales[b, n, r0:r1, None] * ks[None, :]) * scale
                s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
                m = s.amax(dim=-1, keepdim=True)
                p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
                l = p.sum(dim=-1, keepdim=True)
                out[b, n, r0:r1] = ((p @ vf) / torch.where(l == 0.0, torch.ones_like(l), l)).to(v.dtype)
    return out


def _check_kernel_call(q_codes, k_codes, q_scales, k_scales, v, kv_lens):
    """K6's checks; returns kv_lens as contiguous int32 (or None)."""
    fn = "sage_forward"
    device = q_codes.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {device}")
    if v.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: the kernel takes bf16 or fp16 v, got {v.dtype}")
    if q_codes.ndim != 4 or k_codes.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{fn}: codes and v must be (B, N, S, H)")
    batch, heads, seq_q, head_dim = q_codes.shape
    seq_kv = k_codes.shape[2]
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {head_dim} not in {_HEAD_DIMS}")
    if tuple(k_codes.shape) != (batch, heads, seq_kv, head_dim) or tuple(v.shape) != tuple(k_codes.shape):
        raise ValueError(f"{fn}: shapes q {tuple(q_codes.shape)}, k {tuple(k_codes.shape)}, v {tuple(v.shape)}")
    for name, x, dtype in (("q_codes", q_codes, torch.int8), ("k_codes", k_codes, torch.int8), ("v", v, v.dtype)):
        _check_operand(fn, name, x, device, dtype)
    for name, x, s in (("q_scales", q_scales, seq_q), ("k_scales", k_scales, seq_kv)):
        if tuple(x.shape) != (batch, heads, s) or x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{fn}: {name} must be fp32 ({batch}, {heads}, {s}) on {device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if kv_lens is not None:
        if tuple(kv_lens.shape) != (batch,) or kv_lens.device != device:
            raise ValueError(f"{fn}: kv_lens must be ({batch},) on {device}")
        kv_lens = kv_lens.to(torch.int32).contiguous()
    return kv_lens


def sage_forward(
    q_codes: torch.Tensor,
    k_codes: torch.Tensor,
    q_scales: torch.Tensor,
    k_scales: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K6 on BNSH codes and scales (shapes as `sage_attention_reference`) ->
    out (B, N, Sq, H) in v's dtype, a BNSH view of a BTNH-contiguous buffer.

    The kernel takes bf16 or fp16 v with H in {64, 128}, any sequence lengths
    and strided operands (last dim contiguous, 16-byte aligned rows)."""
    if q_codes.device.type == "cpu":
        return sage_attention_reference(q_codes, k_codes, q_scales, k_scales, v, kv_lens, scale)
    kv_lens = _check_kernel_call(q_codes, k_codes, q_scales, k_scales, v, kv_lens)
    batch, heads, seq_q, head_dim = q_codes.shape
    scale = head_dim**-0.5 if scale is None else float(scale)
    out = torch.empty((batch, seq_q, heads, head_dim), dtype=v.dtype, device=v.device).transpose(1, 2)
    fn = _kernel("sage_fwd", "sage_fwd",
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
    strides = _strides(q_codes, k_codes, q_scales, k_scales, v, out)
    with torch.cuda.device(v.device):
        _launch(
            fn, q_codes.data_ptr(), k_codes.data_ptr(), q_scales.data_ptr(), k_scales.data_ptr(), v.data_ptr(),
            out.data_ptr(), _ptr(kv_lens), batch, heads, seq_q, k_codes.shape[2], head_dim, _DTYPE_CODES[v.dtype],
            strides, scale * _LOG2E, _stream(v.device),
        )
    sage_forward.launches += 1
    return out


sage_forward.launches = 0


def sage_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """INT8 QK^T attention on BTNH tensors (query (B, Sq, N, H), key/value
    (B, Skv, Nkv, H)), forward-only; output (B, Sq, N, H) in value's dtype.
    kv_lens (B,) defaults to Skv and is clamped to [0, Skv]; GQA heads are
    repeated (:185-188); scale defaults to H**-0.5."""
    batch, _, num_heads, head_dim = query.shape
    kv_len, num_kv_heads = key.shape[1], key.shape[2]
    scale = head_dim**-0.5 if scale is None else float(scale)
    if kv_lens is None:
        kv_lens = torch.full((batch,), kv_len, dtype=torch.int32, device=query.device)
    else:
        kv_lens = kv_lens.to(device=query.device, dtype=torch.int32).clamp(0, kv_len)
    if num_kv_heads != num_heads:
        rep = num_heads // num_kv_heads
        key = key.repeat_interleave(rep, dim=2)
        value = value.repeat_interleave(rep, dim=2)
    q_codes, k_codes, q_scales, k_scales = sage_quantize(query, key, kv_lens)
    out = sage_forward(q_codes, k_codes, q_scales, k_scales, value.transpose(1, 2), kv_lens, scale)
    return out.transpose(1, 2)
