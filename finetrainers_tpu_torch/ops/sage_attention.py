"""INT8 SageAttention on the H100: the pre-pass and K6, each beside its plain PyTorch version.

Counterpart of `finetrainers_tpu/ops/sage_attention.py`: the Pallas
`_sage_fwd_kernel` becomes the warp-specialised wgmma/TMA kernel
`sage_fwd_sm90_kernel`, and the XLA work before it (the dispatcher's rotation,
smooth-K and the per-token quantization) the pre-pass kernels, all in
`csrc/sage_fwd_sm90.cu`, built by `ops/_build.py`. Forward-only and meant for
serving, as in the JAX package.

  - `sage_quantize(query, key, kv_lens, rope_cos, rope_sin)` is the plain
    pre-pass, in torch ops: with RoPE tables q and k are rotated in fp32 and
    rounded back to their dtype (as the dispatcher rotates them before the JAX
    kernel, `finetrainers_tpu/ops/attention.py:121-135`); smooth-K (k minus
    its fp32 mean over the valid prefix, kept fp32 until it is quantized,
    `_sage_impl` :112-118), then per-token int8 codes with absmax/127 scales
    (`_quantize_per_token`, :96-103). It returns the layout the kernel writes:
    codes (B, N, S, H) int8 and scales (B, N, S) fp32, both contiguous.
  - `sage_prep(...)` launches the pre-pass kernels on CUDA tensors, after
    checking device, dtype, shape and strides, or raises; on CPU tensors it
    computes `sage_quantize`. It counts its launches in `sage_prep.launches`.
  - `sage_attention_reference(...)` is the plain version of K6 on the codes
    and scales: the Pallas kernel's arithmetic (:64-93), in blocks of q rows so
    that it also runs at Wan's 19968-token shape on the card.
  - `sage_forward(...)` launches K6 on CUDA tensors, after the same kind of
    checks, or raises; on CPU tensors it computes the plain version. It counts
    its launches in `sage_forward.launches`.
  - `sage_attention(query, key, value, ...)` is the BTNH entry of the JAX
    package's `sage_attention`, with the RoPE tables the dispatcher fuses:
    kv_lens and scale defaults, GQA head repeat, the pre-pass, then
    `sage_forward`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .flash_attention import (
    _DTYPE_CODES,
    _LOG2E,
    _NEG_INF,
    _check_operand,
    _check_tables,
    _kernel,
    _launch,
    _ptr,
    _rope_fwd,
    _stream,
    _strides,
    WIDE_HEAD_DIMS,
    kernel_tables,
)

# Rows of q per block of the plain version: its fp32 score block is
# (block, Skv), 320 MB at Wan's 19968 keys.
_REFERENCE_BLOCK_Q = 4096
# Rows of k per chunk of the pre-pass kernel's fixed-order partial sums for the mean.
_PREP_SUM_ROWS = 256


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


def _rotate(x: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor) -> torch.Tensor:
    """BTNH x rotated in fp32 with (N or 1, S, H) tables and rounded back to its dtype."""
    return _rope_fwd(x.float(), rope_cos.transpose(0, 1), rope_sin.transpose(0, 1)).to(x.dtype)


def sage_quantize(
    query: torch.Tensor,
    key: torch.Tensor,
    kv_lens: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
):
    """The plain pre-pass on BTNH q (B, Sq, N, H) and k (B, Skv, N, H), with
    kv_lens (B,) and optional fp32 (N or 1, S, H) RoPE tables (Sq == Skv) ->
    (q_codes, k_codes, q_scales, k_scales): codes (B, N, S, H) int8 and scales
    (B, N, S) fp32, contiguous, as `sage_prep` writes them."""
    if rope_cos is not None:
        query, key = _rotate(query, rope_cos, rope_sin), _rotate(key, rope_cos, rope_sin)
    q_codes, q_scales = quantize_per_token(query)
    k_codes, k_scales = quantize_per_token(smooth_k(key, kv_lens))
    return tuple(x.transpose(1, 2).contiguous() for x in (q_codes, k_codes, q_scales, k_scales))


def _check_prep_call(query, key, kv_lens, rope_cos, rope_sin):
    """The pre-pass kernel's checks; returns kv_lens as contiguous int32 and the
    tables' per-head stride."""
    fn = "sage_prep"
    device = query.device
    if query.ndim != 4 or key.ndim != 4:
        raise ValueError(f"{fn}: q and k must be (B, S, N, H)")
    batch, seq_q, heads, head_dim = query.shape
    if head_dim not in WIDE_HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {head_dim} not in {WIDE_HEAD_DIMS} (K6 and its pre-pass at other head "
                         "dims are still to port: ROADMAP.md queue 2 item 5)")
    if device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {device}")
    if query.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: the kernel takes bf16 or fp16, got {query.dtype}")
    if (key.shape[0], key.shape[2], key.shape[3]) != (batch, heads, head_dim):
        raise ValueError(f"{fn}: shapes q {tuple(query.shape)}, k {tuple(key.shape)}")
    for name, x in (("q", query), ("k", key)):
        _check_operand(fn, name, x, device, query.dtype)
    if tuple(kv_lens.shape) != (batch,) or kv_lens.device != device:
        raise ValueError(f"{fn}: kv_lens must be ({batch},) on {device}")
    rope_sn = _check_tables(fn, rope_cos, rope_sin, heads, seq_q, key.shape[1], head_dim, device)
    return kv_lens.to(torch.int32).contiguous(), rope_sn


def sage_prep(
    query: torch.Tensor,
    key: torch.Tensor,
    kv_lens: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
):
    """The pre-pass (arguments and result as `sage_quantize`). On a CPU tensor
    the plain version; on a CUDA tensor the kernels (bf16 or fp16, H in {64,
    128}, strided BTNH q and k with a contiguous H and 16-byte aligned rows),
    or it raises."""
    if query.device.type == "cpu":
        return sage_quantize(query, key, kv_lens, rope_cos, rope_sin)
    kv_lens, rope_sn = _check_prep_call(query, key, kv_lens, rope_cos, rope_sin)
    batch, seq_q, heads, head_dim = query.shape
    seq_kv = key.shape[1]
    device = query.device
    q_codes = torch.empty((batch, heads, seq_q, head_dim), dtype=torch.int8, device=device)
    k_codes = torch.empty((batch, heads, seq_kv, head_dim), dtype=torch.int8, device=device)
    q_scales = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=device)
    k_scales = torch.empty((batch, heads, seq_kv), dtype=torch.float32, device=device)
    chunks = -(-seq_kv // _PREP_SUM_ROWS)
    scratch = torch.empty(batch * heads * (chunks + 1) * head_dim, dtype=torch.float32, device=device)
    fn = _kernel("sage_fwd_sm90", "sage_prep",
                 [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    strides = (ctypes.c_int64 * 6)(*(st for x in (query, key) for st in (x.stride(0), x.stride(2), x.stride(1))))
    with torch.cuda.device(device):
        _launch(
            fn, query.data_ptr(), key.data_ptr(), kv_lens.data_ptr(), _ptr(rope_cos), _ptr(rope_sin),
            q_codes.data_ptr(), k_codes.data_ptr(), q_scales.data_ptr(), k_scales.data_ptr(), scratch.data_ptr(),
            batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[query.dtype], strides, rope_sn, _PREP_SUM_ROWS,
            _stream(device),
        )
    sage_prep.launches += 1
    return q_codes, k_codes, q_scales, k_scales


sage_prep.launches = 0


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
    if q_codes.ndim != 4 or k_codes.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{fn}: codes and v must be (B, N, S, H)")
    batch, heads, seq_q, head_dim = q_codes.shape
    seq_kv = k_codes.shape[2]
    if head_dim not in WIDE_HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {head_dim} not in {WIDE_HEAD_DIMS} (K6 and its pre-pass at other head "
                         "dims are still to port: ROADMAP.md queue 2 item 5)")
    if device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {device}")
    if v.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: the kernel takes bf16 or fp16 v, got {v.dtype}")
    if tuple(k_codes.shape) != (batch, heads, seq_kv, head_dim) or tuple(v.shape) != tuple(k_codes.shape):
        raise ValueError(f"{fn}: shapes q {tuple(q_codes.shape)}, k {tuple(k_codes.shape)}, v {tuple(v.shape)}")
    for name, x, dtype in (("q_codes", q_codes, torch.int8), ("k_codes", k_codes, torch.int8), ("v", v, v.dtype)):
        _check_operand(fn, name, x, device, dtype)
    for name, x in (("q_codes", q_codes), ("k_codes", k_codes)):
        if any(st % 16 for st in x.stride()[:-1]):  # TMA steps whole 16-byte units
            raise ValueError(f"{fn}: {name} strides must be multiples of 16 (strides {x.stride()})")
    for name, x, s in (("q_scales", q_scales, seq_q), ("k_scales", k_scales, seq_kv)):
        if (tuple(x.shape) != (batch, heads, s) or x.dtype != torch.float32 or x.device != device
                or not x.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous fp32 ({batch}, {heads}, {s}) on {device}, "
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

    The kernel takes bf16 or fp16 v with H in {64, 128} and any sequence
    lengths; codes with a contiguous H and strides that are multiples of 16
    (the pre-pass writes them contiguous), contiguous scales, and a strided v
    (last dim contiguous, 16-byte aligned rows)."""
    if q_codes.device.type == "cpu":
        return sage_attention_reference(q_codes, k_codes, q_scales, k_scales, v, kv_lens, scale)
    kv_lens = _check_kernel_call(q_codes, k_codes, q_scales, k_scales, v, kv_lens)
    batch, heads, seq_q, head_dim = q_codes.shape
    scale = head_dim**-0.5 if scale is None else float(scale)
    out = torch.empty((batch, seq_q, heads, head_dim), dtype=v.dtype, device=v.device).transpose(1, 2)
    fn = _kernel("sage_fwd_sm90", "sage_fwd_sm90",
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(v.device):
        _launch(
            fn, q_codes.data_ptr(), k_codes.data_ptr(), q_scales.data_ptr(), k_scales.data_ptr(), v.data_ptr(),
            out.data_ptr(), _ptr(kv_lens), batch, heads, seq_q, k_codes.shape[2], head_dim, _DTYPE_CODES[v.dtype],
            _strides(q_codes, k_codes, v, out), scale * _LOG2E, _stream(v.device),
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
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """INT8 QK^T attention on BTNH tensors (query (B, Sq, N, H), key/value
    (B, Skv, Nkv, H)), forward-only; output (B, Sq, N, H) in value's dtype.
    kv_lens (B,) defaults to Skv and is clamped to [0, Skv]; GQA heads are
    repeated (:185-188); scale defaults to H**-0.5. rope_cos/rope_sin:
    optional fp32 tables, (S, N*H) or (S, H) as `flash_attention` takes them
    (Sq == Skv), that the pre-pass applies to q and k."""
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
    rope_cos, rope_sin = kernel_tables(query, key, rope_cos, rope_sin)
    q_codes, k_codes, q_scales, k_scales = sage_prep(query, key, kv_lens, rope_cos, rope_sin)
    out = sage_forward(q_codes, k_codes, q_scales, k_scales, value.transpose(1, 2), kv_lens, scale)
    return out.transpose(1, 2)
