"""Flash attention on the H100: K1 (forward) and its variants K7a-c, K2/K3
(backward) and the fused backward K5, the pre-pass they share, and the
autograd glue K4, each kernel beside its plain PyTorch version.

Counterpart of `finetrainers_tpu/ops/flash_attention.py`: the Pallas
`_fwd_kernel` and `_fwd_kernel_twopass` become the wgmma/TMA kernels in
`csrc/flash_fwd_sm90.cu` (K1, K7a); `_fwd_kernel`'s `two_level` branch and
`_fwd_kernel_skew` become the mma.sync kernels in `csrc/flash_fwd.cu` (K7c,
K7b); `_bwd_dkdv_kernel`, `_bwd_dq_kernel` and `_bwd_fused_kernel` become the
wgmma/TMA kernels in `csrc/flash_bwd_sm90.cu` (K2, K3, K5), and
`csrc/flash_bwd.cu` holds K5's dq emit and the pre-pass that rotates and
scales q and k once per call for every kernel but K7b; all are built by
`ops/_build.py`.

  - `flash_qk_prep` is the pre-pass: q_s = T(rope(q) * scale * log2e) and,
    with tables, k_r = T(rope(k)) (T() rounds to the input dtype), the
    operands K1, K7a, K7c, K2, K3 and K5 read instead of rotating and scaling
    per CTA.
  - `flash_forward(q, k, v, ...)` works on BNSH tensors and returns
    `(out, lse)`, like `_flash_forward`. On a CUDA tensor it launches the
    pre-pass and then K1 (`flash_forward_core`, on q_s and k_r), after checking
    device, dtype, shape and strides, or raises; on a CPU tensor it computes
    `flash_attention_reference`. Like `_flash_forward`, it
    reads three switches at call time, with the JAX package's precedence:
    FINETRAINERS_FLASH_SKEW=1 takes K7b (`flash_forward_skew`) for calls
    without RoPE tables, else FINETRAINERS_FLASH_TWOPASS=1 takes K7a
    (`flash_forward_twopass`), else FINETRAINERS_FLASH_TWOLEVEL=1 takes K7c
    (`flash_forward_two_level`).
  - `flash_backward(q, k, v, out, lse, do, ...)` returns `(dq, dk, dv)`, like
    `_flash_backward`, from a caller-given LSE. On a CUDA tensor it launches
    the pre-pass, K2 and K3 after the same checks, or raises; on a CPU tensor
    it computes `flash_backward_reference`. With
    FINETRAINERS_FLASH_FUSED_BWD=1 it launches the pre-pass, K5
    (`flash_bwd_fused`) and its dq emit instead, or computes
    `flash_backward_fused_reference` on a CPU tensor. The JAX package takes K5
    only while its full-length dq accumulator fits VMEM
    (`q_pad * head_dim * 6 <= 3 MB`); K5's accumulator lives in device memory
    here, so the switch alone decides.
  - `FlashAttentionFunction` (K4) is the `torch.autograd.Function` joining
    them, the counterpart of the `jax.custom_vjp` `_flash_mha`.
  - `flash_attention(query, key, value, ...)` is the BTNH interface of the JAX
    package's `flash_attention`, including its RoPE table conventions; it goes
    through K4 on every device, so its backward is K2/K3 or K5 (or their plain
    versions on the CPU), never autograd through the forward's math.
  - `flash_attention_reference` / `flash_backward_reference` are the plain
    fp32 math of the kernels: the same base-2 softmax, cast points, masking and
    natural-log LSE. `flash_attention_reference` is the plain pre-pass
    (`flash_qk_prep_reference`) followed by K1's plain version
    (`flash_forward_core_reference`); `flash_backward_reference` is the plain
    pre-pass followed by K2's and K3's (`flash_bwd_dkdv_reference`,
    `flash_bwd_dq_reference`). The `*_twopass`, `*_skew`, `*_two_level`
    and `flash_backward_fused_reference` versions follow their kernel's
    recurrence over kv tiles of the kernel's width (128 keys for K7a and K5,
    64 for K7b and K7c), so their fp32 sums run in the kernel's tile order.

Each kernel wrapper keeps a `launches` count (`flash_qk_prep`,
`flash_forward_two_level`, `flash_forward_twopass`, `flash_forward_skew`,
`flash_bwd_dkdv`, `flash_bwd_dq`, `flash_bwd_fused`, `flash_bwd_dq_emit`; K1's
launches, from `flash_forward` or `flash_forward_core`, count on
`flash_forward`) of kernel launches, never of reference calls, so a run can
show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from ._build import load_library

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
_BLOCK_KV = 64  # the kv tile of the mma.sync K7b and K7c (csrc/flash_fwd.cu)
_SM90_BLOCK_KV = 128  # the kv tile of the wgmma K7a and K5 (a K5 CTA's kv rows)
_BWD_ROWS = 128  # kv rows of a K2 CTA (csrc/flash_bwd_sm90.cu)
_BWD_BLOCK_Q = 64  # K2's streamed q tile
_MAX_DKDV_SPLITS = 8


def _switch(name: str) -> bool:
    """Whether the JAX package's switch `name` is set to "1", read per call."""
    return os.environ.get(name, "0") == "1"


def forward_variant(has_rope: bool):
    """The forward variant the switches pick for a call (`_flash_forward`'s gates,
    :724-733, :816): `flash_forward_skew` (never with RoPE tables), then
    `flash_forward_twopass`, then `flash_forward_two_level`, else None (K1)."""
    if _switch("FINETRAINERS_FLASH_SKEW") and not has_rope:
        return flash_forward_skew
    if _switch("FINETRAINERS_FLASH_TWOPASS"):
        return flash_forward_twopass
    if _switch("FINETRAINERS_FLASH_TWOLEVEL"):
        return flash_forward_two_level
    return None


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


def flash_qk_prep_reference(q, k, rope_cos, rope_sin, scale):
    """Plain version of the pre-pass (`flash_qk_prep`): q_s = T(rope(q) *
    scale * log2e) and k_r = T(rope(k)), where T() rounds to the input dtype,
    returned as fp32."""
    qf, kf = q.float(), k.float()
    if rope_cos is not None:
        qf = _rope_fwd(qf, rope_cos, rope_sin)
        kf = _rope_fwd(kf, rope_cos, rope_sin)
    return (qf * (scale * _LOG2E)).to(q.dtype).float(), kf.to(k.dtype).float()


def _finish(acc, m, l, dtype):
    """(acc / l in `dtype`, natural-log LSE m*ln2 + log l); a row with l == 0 gives 0."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe).to(dtype), (m * _LN2 + torch.log(l_safe)).squeeze(-1)


def flash_forward_core_reference(
    q_s: torch.Tensor,
    k_r: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 version of K1 (`flash_forward_core`) on the pre-pass's
    operands: q_s (B, N, Sq, H) already rotated, scaled by scale * log2e and
    rounded; k_r (B, N, Skv, H) rotated and rounded; v (B, N, Skv, H) in the
    output dtype; kv_lens (B,) ints. Base-2 softmax with keys at or past
    kv_lens[b] selected out. Returns out in v's dtype and the (B, N, Sq) fp32
    natural-log LSE; a row with no valid key gives 0 and -1e30*ln2."""
    return _attend(q_s, k_r, v, kv_lens, v.dtype)


def _attend(q_s, k_r, v, kv_lens, dtype):
    """K1's plain math on the pre-pass's operands, the output rounded to `dtype`."""
    s = q_s.float() @ k_r.float().transpose(-1, -2)  # base-2 logits
    valid = _valid_keys(kv_lens, q_s.shape[0], k_r.shape[2], q_s.device)
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * valid
    return _finish(p @ v.float(), m, p.sum(dim=-1, keepdim=True), dtype)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 version of `flash_forward` (the pre-pass, then K1). q: (B, N,
    Sq, H); k, v: (B, N, Skv, H); kv_lens: (B,) ints; rope tables: (N or 1, S,
    H) fp32. Returns out in q's dtype and the (B, N, Sq) fp32 natural-log LSE.
    Like the kernels, the rotated and scaled q and the rotated k are rounded to
    the input dtype before QK^T."""
    scale = q.shape[-1]**-0.5 if scale is None else scale
    qs, kr = flash_qk_prep_reference(q, k, rope_cos, rope_sin, scale)
    return _attend(qs, kr, v, kv_lens, q.dtype)


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
    """Plain fp32 version of `flash_backward` (the pre-pass, then K2 and K3;
    BNSH, shapes as `flash_forward`; lse natural-log (B, N, Sq) fp32). Rounds
    where the kernels and `_flash_backward` round: q_s and k_r as in the
    forward; p to the input dtype before the dv product; ds = T(p * T(dp -
    delta)); delta = rowsum(dO * out) in fp32 over the rounded `out` unless
    given; dk = rope^T(ln2 * ds^T q_s) and dq = rope^T(scale * ds k_r) in fp32,
    then rounded. Masked keys are selected to p = ds = 0 (a row with no valid
    key has an LSE of -1e30*ln2, where exp2 overflows). Returns (dq, dk, dv) in
    the input dtypes."""
    scale = q.shape[-1]**-0.5 if scale is None else scale
    qs, kr = flash_qk_prep_reference(q, k, rope_cos, rope_sin, scale)
    if delta is None:
        delta = (do.float() * out.float()).sum(-1)
    dk, dv = flash_bwd_dkdv_reference(qs, kr, v, do, lse, delta, kv_lens, rope_cos, rope_sin)
    return flash_bwd_dq_reference(qs, kr, v, do, lse, delta, kv_lens, rope_cos, rope_sin, scale), dk, dv


def _bwd_scores(q_s, k_r, v, do, lse, delta, valid):
    """(p, ds) of the backward for q rows `q_s`/`do`/`lse`/`delta` against all
    keys, (B, N, Sq, Skv) fp32 at the kernels' rounding points (T = v's dtype),
    both selected to 0 where `valid` (B, 1, 1, Skv) is False."""
    dtype = v.dtype
    s = q_s.float() @ k_r.float().transpose(-1, -2)
    p = torch.exp2(s - (lse * _LOG2E)[..., None]).to(dtype).float()
    p = torch.where(valid, p, torch.zeros_like(p))
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta[..., None]).to(dtype).float()).to(dtype).float()
    return p, torch.where(valid, ds, torch.zeros_like(ds))


def flash_bwd_dkdv_reference(q_s, k_r, v, do, lse, delta, kv_lens=None, rope_cos=None, rope_sin=None, splits=1):
    """Plain version of K2 (`flash_bwd_dkdv`) on the pre-pass's operands (q_s,
    k_r as `flash_forward_core_reference` takes them; v, do in the input dtype;
    lse, delta (B, N, Sq) fp32): dk = T(rope^T(ln2 * ds^T q_s)) with k's tables
    and dv = T(p^T dO), 0 at keys >= kv_lens[b]. With `splits` > 1 the q rows
    are cut as K2 cuts its q loop for cross-attention (whole q tiles,
    `dkdv_splits`): each range's fp32 partial sums are taken alone and then
    added, as K2's reduce pass adds them."""
    dtype = v.dtype
    seq_q = q_s.shape[2]
    valid = _valid_keys(kv_lens, q_s.shape[0], k_r.shape[2], q_s.device)
    q_tiles = -(-seq_q // _BWD_BLOCK_Q)
    rows = -(-q_tiles // splits) * _BWD_BLOCK_Q  # whole q tiles per range
    dk = dv = 0.0
    for q0 in range(0, seq_q, rows):
        part = slice(q0, q0 + rows)
        p, ds = _bwd_scores(q_s[:, :, part], k_r, v, do[:, :, part], lse[:, :, part], delta[:, :, part], valid)
        dv = dv + p.transpose(-1, -2) @ do[:, :, part].float()
        dk = dk + ds.transpose(-1, -2) @ q_s[:, :, part].float()
    dk = dk * _LN2
    if rope_cos is not None:
        dk = _rope_bwd(dk, rope_cos, rope_sin)
    return dk.to(dtype), dv.to(dtype)


def flash_bwd_dq_reference(q_s, k_r, v, do, lse, delta, kv_lens=None, rope_cos=None, rope_sin=None, scale=None):
    """Plain version of K3 (`flash_bwd_dq`) on the pre-pass's operands
    (arguments as `flash_bwd_dkdv_reference`): dq = T(rope^T(scale * ds k_r))
    with q's tables; a batch row with no valid key gets 0."""
    scale = q_s.shape[-1]**-0.5 if scale is None else scale
    valid = _valid_keys(kv_lens, q_s.shape[0], k_r.shape[2], q_s.device)
    _, ds = _bwd_scores(q_s, k_r, v, do, lse, delta, valid)
    dq = (ds @ k_r.float()) * scale
    if rope_cos is not None:
        dq = _rope_bwd(dq, rope_cos, rope_sin)
    return dq.to(v.dtype)


def _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, block):
    """(q_s, [(k_r tile, v tile, valid-key tile) for each `block`-key tile]) for
    the tiled plain versions; the tiles are fp32 except v, kept in its dtype."""
    batch, _, _, head_dim = q.shape
    scale = head_dim**-0.5 if scale is None else scale
    qs, kr = flash_qk_prep_reference(q, k, rope_cos, rope_sin, scale)
    valid = _valid_keys(kv_lens, batch, k.shape[2], q.device)
    return qs, [(kr[:, :, k0:k0 + block], v[:, :, k0:k0 + block], valid[..., k0:k0 + block])
                for k0 in range(0, k.shape[2], block)]


def _pv(p: torch.Tensor, v_tile: torch.Tensor) -> torch.Tensor:
    """p v with p rounded to v's dtype first, as the kernels feed their P V product."""
    return p.to(v_tile.dtype).float() @ v_tile.float()


def _running_state(q):
    batch, heads, seq_q, head_dim = q.shape
    m = torch.full((batch, heads, seq_q, 1), _NEG_INF, device=q.device)
    return m, torch.zeros_like(m), torch.zeros((batch, heads, seq_q, head_dim), device=q.device)


def flash_forward_two_level_reference(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None):
    """Plain version of K7c (`_fwd_kernel`'s `two_level` branch): per 64-key
    tile, p = exp2(s - m_cur) against the tile's own max, beta = exp2(m_cur -
    m_new), l = l*alpha + rowsum(p)*beta, acc = acc*alpha + (p v)*beta.
    Arguments and result as `flash_attention_reference`."""
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _BLOCK_KV)
    m, l, acc = _running_state(q)
    for kr, vt, valid in tiles:
        s = (qs @ kr.transpose(-1, -2)).masked_fill(~valid, _NEG_INF)
        m_cur = s.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        alpha, beta = torch.exp2(m - m_new), torch.exp2(m_cur - m_new)
        p = torch.where(valid, torch.exp2(s - m_cur), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True) * beta
        acc = acc * alpha + _pv(p, vt) * beta
        m = m_new
    return _finish(acc, m, l, q.dtype)


def flash_forward_twopass_reference(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None):
    """Plain version of K7a (`_fwd_kernel_twopass`): a first sweep over the
    128-key tiles takes the row max; a second accumulates p = exp2(s - m) against
    that final max with no rescale (a row with no valid key selects p to 0).
    Arguments and result as `flash_attention_reference`."""
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _SM90_BLOCK_KV)
    m, l, acc = _running_state(q)
    for kr, _, valid in tiles:
        m = torch.maximum(m, (qs @ kr.transpose(-1, -2)).masked_fill(~valid, _NEG_INF).amax(dim=-1, keepdim=True))
    for kr, vt, valid in tiles:
        s = (qs @ kr.transpose(-1, -2)).masked_fill(~valid, _NEG_INF)
        p = torch.where(valid, torch.exp2(s - m), torch.zeros_like(s))
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + _pv(p, vt)
    return _finish(acc, m, l, q.dtype)


def flash_forward_skew_reference(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None):
    """Plain version of K7b (`_fwd_kernel_skew`): K1's online-softmax step on
    each 64-key tile in turn, after a first step on a dummy tile of 2*(-1e30)
    (p = 0, alpha = 1); masked entries are recovered from the stored scores
    (`s > 0.5 * -1e30`). Arguments and result as `flash_attention_reference`."""
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _BLOCK_KV)
    m, l, acc = _running_state(q)
    dummy = torch.full(qs.shape[:-1] + (1,), 2.0 * _NEG_INF, device=q.device)
    steps = [(dummy, None)] + [((qs @ kr.transpose(-1, -2)).masked_fill(~valid, _NEG_INF), vt)
                               for kr, vt, valid in tiles]
    for s, vt in steps:
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(s > 0.5 * _NEG_INF, torch.exp2(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + (0.0 if vt is None else _pv(p, vt))
        m = m_new
    return _finish(acc, m, l, q.dtype)


def flash_backward_fused_reference(
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
    """Plain version of K5 (`_bwd_fused_kernel`): `flash_backward_reference`'s
    quantities at its rounding points, computed once per 128-key tile (a K5
    CTA's kv rows), with each tile's ds k_r added into an fp32 dq accumulator,
    as K5 adds them. Arguments and result as `flash_backward_reference`."""
    dtype = q.dtype
    scale = q.shape[-1]**-0.5 if scale is None else scale
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _SM90_BLOCK_KV)
    dof = do.float()
    if delta is None:
        delta = (dof * out.float()).sum(-1)
    lse2 = (lse * _LOG2E)[..., None]
    dq_acc = torch.zeros(qs.shape, device=q.device)
    dks, dvs = [], []
    for kr, vt, valid in tiles:
        p = torch.exp2(qs @ kr.transpose(-1, -2) - lse2).to(dtype).float()
        p = torch.where(valid, p, torch.zeros_like(p))
        dvs.append(p.transpose(-1, -2) @ dof)
        dp = dof @ vt.float().transpose(-1, -2)
        ds = (p * (dp - delta[..., None]).to(dtype).float()).to(dtype).float()
        dks.append((ds.transpose(-1, -2) @ qs) * _LN2)
        dq_acc = dq_acc + ds @ kr
    dk, dv, dq = torch.cat(dks, dim=2), torch.cat(dvs, dim=2), dq_acc * scale
    if rope_cos is not None:
        dk = _rope_bwd(dk, rope_cos, rope_sin)
        dq = _rope_bwd(dq, rope_cos, rope_sin)
    return dq.to(dtype), dk.to(k.dtype), dv.to(v.dtype)


_KERNELS = {}


def _kernel(library: str, fn_name: str, argtypes):
    """The C entry point `fn_name` of `csrc/<library>.cu`, built and typed on first use."""
    fn = _KERNELS.get(fn_name)
    if fn is None:
        fn = getattr(load_library(library), fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _KERNELS[fn_name] = fn
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
    return kv_lens, _check_tables(fn, rope_cos, rope_sin, heads, seq_q, seq_kv, head_dim, q.device)


def _check_tables(fn, rope_cos, rope_sin, heads, seq_q, seq_kv, head_dim, device) -> int:
    """The checks of a kernel's RoPE tables, (N or 1, S, H) contiguous fp32 on
    `device`, for self-attention shapes; returns their per-head stride (0 for
    one table shared by every head, and without tables)."""
    if rope_cos is None:
        return 0
    if seq_q != seq_kv:
        raise ValueError(f"{fn}: fused RoPE needs self-attention shapes (Sq == Skv)")
    for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != device or t.data_ptr() % 16
                or t.ndim != 3 or t.shape[0] not in (1, heads) or tuple(t.shape[1:]) != (seq_q, head_dim)):
            raise ValueError(
                f"{fn}: {name} must be contiguous, 16-byte aligned fp32 (N or 1, S, H) on {device}, "
                f"got {tuple(t.shape)} {t.dtype}"
            )
    if rope_sin.shape != rope_cos.shape:
        raise ValueError(f"{fn}: rope_cos and rope_sin shapes differ")
    return 0 if rope_cos.shape[0] == 1 else seq_q * head_dim


def flash_qk_prep(q, k, rope_cos, rope_sin, rope_sn: int, scale: float):
    """The pre-pass, on operands the caller has checked: q_s = T(rope(q) *
    scale * log2e) and, with tables, k_r = T(rope(k)), both (B, N, S, H)
    contiguous. Without tables k_r is k itself. Every forward but K7b and every
    backward launches it once."""
    batch, heads, seq_q, head_dim = q.shape
    q_s = torch.empty((batch, heads, seq_q, head_dim), dtype=q.dtype, device=q.device)
    k_r = k if rope_cos is None else torch.empty(k.shape, dtype=k.dtype, device=k.device)
    fn = _kernel("flash_bwd", "flash_qk_prep",
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 7 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        _launch(
            fn, q.data_ptr(), k.data_ptr(), q_s.data_ptr(), None if rope_cos is None else k_r.data_ptr(),
            _ptr(rope_cos), _ptr(rope_sin), batch, heads, seq_q, k.shape[2], head_dim, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], rope_sn, scale * _LOG2E, _stream(q.device),
        )
    flash_qk_prep.launches += 1
    return q_s, k_r


flash_qk_prep.launches = 0


def _sm90_forward(entry, q_s, k_r, v, kv_lens):
    """Launch `entry` of `csrc/flash_fwd_sm90.cu` (`flash_fwd_sm90`, K1, or
    `flash_fwd_twopass_sm90`, K7a) on checked operands -> (out, lse); the
    caller counts the launch."""
    batch, heads, seq_q, head_dim = q_s.shape
    out = _btnh_like(q_s)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q_s.device)
    fn = _kernel("flash_fwd_sm90", entry,
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(kv_lens),
            batch, heads, seq_q, k_r.shape[2], head_dim, _DTYPE_CODES[q_s.dtype], _strides(q_s, k_r, v, out),
            _stream(q_s.device),
        )
    return out, lse


def _k1(q_s, k_r, v, kv_lens):
    """Launch K1 on checked operands; counted on `flash_forward.launches`."""
    out = _sm90_forward("flash_fwd_sm90", q_s, k_r, v, kv_lens)
    flash_forward.launches += 1
    return out


def flash_forward_core(
    q_s: torch.Tensor,
    k_r: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 alone, on the pre-pass's operands (see `flash_forward_core_reference`)
    -> (out, lse); `flash_forward` is the pre-pass followed by this. On a CPU
    tensor the plain version; on a CUDA tensor the kernel, after the checks of
    `flash_forward`, or it raises. Launches count on `flash_forward.launches`."""
    if q_s.device.type == "cpu":
        return flash_forward_core_reference(q_s, k_r, v, kv_lens)
    kv_lens, _ = _check_kernel_call("flash_forward_core", q_s, k_r, v, kv_lens, None, None)
    return _k1(q_s, k_r, v, kv_lens)


def flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass and K1 on BNSH tensors -> (out (B, N, Sq, H) in q's dtype,
    lse (B, N, Sq) fp32), or K7a/b/c where a switch picks them (`forward_variant`).

    The kernel takes bf16 or fp16 with H in {64, 128} and any sequence lengths;
    fused RoPE needs Sq == Skv and (N or 1, S, H) fp32 tables. `out` is a BNSH
    view of a BTNH-contiguous buffer, so `out.transpose(1, 2)` is contiguous."""
    variant = forward_variant(rope_cos is not None)
    if variant is not None:
        return variant(q, k, v, kv_lens, rope_cos, rope_sin, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_lens, rope_cos, rope_sin, scale)
    kv_lens, rope_sn = _check_kernel_call("flash_forward", q, k, v, kv_lens, rope_cos, rope_sin)
    scale = q.shape[-1]**-0.5 if scale is None else float(scale)
    q_s, k_r = flash_qk_prep(q, k, rope_cos, rope_sin, rope_sn, scale)
    return _k1(q_s, k_r, v, kv_lens)


flash_forward.launches = 0


def _forward_kernel(fn_name, variant, q, k, v, kv_lens, rope_cos, rope_sin, scale):
    """Check a forward call and launch variant `variant`: 2, K7a, is
    `flash_fwd_twopass_sm90` of `csrc/flash_fwd_sm90.cu`; 1, K7c, and 3, K7b,
    are the C entry point's codes in `csrc/flash_fwd.cu` (0, K1, is
    `flash_fwd_sm90.cu`'s). K7a and K7c run on the pre-pass's operands; K7b,
    which takes no tables, scales q itself."""
    kv_lens, rope_sn = _check_kernel_call(fn_name, q, k, v, kv_lens, rope_cos, rope_sin)
    batch, heads, seq_q, head_dim = q.shape
    seq_kv = k.shape[2]
    scale = head_dim**-0.5 if scale is None else float(scale)
    qscale = scale * _LOG2E
    if variant != 3:
        q, k = flash_qk_prep(q, k, rope_cos, rope_sin, rope_sn, scale)
        qscale = 1.0
    if variant == 2:
        return _sm90_forward("flash_fwd_twopass_sm90", q, k, v, kv_lens)

    out = _btnh_like(q)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device)
    fn = _kernel("flash_fwd", "flash_fwd",
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        _launch(
            fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(kv_lens),
            batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q.dtype], variant,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], qscale, _stream(q.device),
        )
    return out, lse


def _forward_variant(name: str, variant: int, plain: str, takes_rope: bool, doc: str):
    """A K7 wrapper: on a CPU tensor the plain version named `plain` (looked up
    per call), else kernel `variant` (`_forward_kernel`), counted in its own
    `launches`. Without `takes_rope` it refuses RoPE tables."""

    def wrapper(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None):
        if rope_cos is not None and not takes_rope:
            raise ValueError(f"{name}: this kernel takes no RoPE tables")
        if q.device.type == "cpu":
            return globals()[plain](q, k, v, kv_lens, rope_cos, rope_sin, scale)
        out = _forward_kernel(name, variant, q, k, v, kv_lens, rope_cos, rope_sin, scale)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


flash_forward_two_level = _forward_variant(
    "flash_forward_two_level", 1, "flash_forward_two_level_reference", True,
    "K7c: `flash_forward`'s function through the two-level recurrence, after the pre-pass. Takes what K1 takes.")
flash_forward_twopass = _forward_variant(
    "flash_forward_twopass", 2, "flash_forward_twopass_reference", True,
    "K7a: `flash_forward`'s function in two passes (max, then accumulate), after the pre-pass. Takes what K1 "
    "takes.")
flash_forward_skew = _forward_variant(
    "flash_forward_skew", 3, "flash_forward_skew_reference", False,
    "K7b: `flash_forward`'s function, software-pipelined. Takes what K1 takes except RoPE tables "
    "(the JAX package gates the skewed kernel off RoPE; `flash_forward` sends such calls to K1).")


_BWD_ARGTYPES = [ctypes.c_void_p] * 9


def dkdv_splits(batch: int, heads: int, seq_q: int, seq_kv: int, sms: int) -> Tuple[int, int]:
    """(splits, q tiles per split) for K2. K2 runs one CTA per 128-row kv tile
    of a (batch, head), looping over the q tiles; where those CTAs are fewer
    than the card's `sms` (cross-attention over a few hundred keys), the loop
    is cut into up to 8 ranges of whole q tiles, one CTA each, picking the cut
    that leaves the fewest waves of CTAs per unit of work. Each range is at
    least 2 q tiles."""
    kv_ctas = batch * heads * -(-seq_kv // _BWD_ROWS)
    q_tiles = -(-seq_q // _BWD_BLOCK_Q)
    splits, best = 1, 1.0
    if kv_ctas < sms:
        for count in range(2, min(_MAX_DKDV_SPLITS, q_tiles // 2) + 1):
            waves = -(-kv_ctas * count // sms) / count
            if waves < best:
                splits, best = count, waves
    per = -(-q_tiles // splits)
    return -(-q_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_q_loop(q_s, k_r):
    """(splits, q tiles per split, fp32 partials or None) for K2's or K5's q
    loop (`dkdv_splits`): with splits > 1, the (2, splits, B, N, Skv, H) partial
    dk and dv the reduce pass sums."""
    batch, heads, seq_q, head_dim = q_s.shape
    seq_kv = k_r.shape[2]
    splits, per = dkdv_splits(batch, heads, seq_q, seq_kv, _sm_count(q_s.device.index or 0))
    partials = None
    if splits > 1:
        partials = torch.empty((2, splits, batch, heads, seq_kv, head_dim), dtype=torch.float32, device=q_s.device)
    return splits, per, partials


def flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int):
    """K2 on operands `flash_backward` has checked, with q_s/k_r from
    `flash_qk_prep`: (dk, dv), BNSH views of BTNH-contiguous buffers. On a CUDA
    tensor it launches the wgmma kernel of `csrc/flash_bwd_sm90.cu` and, where
    `dkdv_splits` cuts its q loop, the reduce pass that sums the fp32 partials;
    on a CPU tensor it computes `flash_bwd_dkdv_reference`."""
    if q_s.device.type == "cpu":
        return flash_bwd_dkdv_reference(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin)
    batch, heads, seq_q, head_dim = q_s.shape
    seq_kv = k_r.shape[2]
    dk, dv = _btnh_like(k_r), _btnh_like(v)
    splits, per, partials = _split_q_loop(q_s, k_r)
    fn = _kernel("flash_bwd_sm90", "flash_bwd_dkdv_sm90",
                 _BWD_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin), dk.data_ptr(), dv.data_ptr(), _ptr(partials),
            batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q_s.dtype], _strides(q_s, k_r, v, do, dk, dv),
            rope_sn, splits, per, _stream(q_s.device),
        )
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int, scale: float):
    """K3 on operands `flash_backward` has checked, with q_s/k_r from
    `flash_qk_prep`: dq, a BNSH view of a BTNH-contiguous buffer. On a CUDA
    tensor it launches the wgmma kernel of `csrc/flash_bwd_sm90.cu`; on a CPU
    tensor it computes `flash_bwd_dq_reference`."""
    if q_s.device.type == "cpu":
        return flash_bwd_dq_reference(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, scale)
    batch, heads, seq_q, head_dim = q_s.shape
    dq = _btnh_like(q_s)
    fn = _kernel("flash_bwd_sm90", "flash_bwd_dq_sm90",
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


def flash_bwd_fused(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int):
    """K5 on operands `flash_backward` has checked, with q_s/k_r from
    `flash_qk_prep`: (dq_acc, dk, dv), dq_acc the fp32 (B, N, Sq, H) sum of
    ds k_r before the scale and the transpose rotation (`flash_bwd_dq_emit`),
    dk and dv BNSH views of BTNH-contiguous buffers. It launches the wgmma
    kernel of `csrc/flash_bwd_sm90.cu` and, where `dkdv_splits` cuts its q loop
    as it cuts K2's, K2's reduce pass; dq_acc is zeroed here, and the kernel
    adds into it in an order that varies from run to run."""
    batch, heads, seq_q, head_dim = q_s.shape
    seq_kv = k_r.shape[2]
    dk, dv = _btnh_like(k_r), _btnh_like(v)
    dq_acc = torch.zeros((batch, heads, seq_q, head_dim), dtype=torch.float32, device=q_s.device)
    splits, per, partials = _split_q_loop(q_s, k_r)
    fn = _kernel("flash_bwd_sm90", "flash_bwd_fused_sm90",
                 _BWD_ARGTYPES + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin), dk.data_ptr(), dv.data_ptr(), _ptr(partials),
            dq_acc.data_ptr(), batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q_s.dtype],
            _strides(q_s, k_r, v, do, dk, dv), rope_sn, splits, per, _stream(q_s.device),
        )
    flash_bwd_fused.launches += 1
    return dq_acc, dk, dv


flash_bwd_fused.launches = 0


def flash_bwd_dq_emit(dq_acc, rope_cos, rope_sin, rope_sn: int, scale: float, dtype: torch.dtype):
    """K5's emit: dq = rope^T(scale * dq_acc) in `dtype`, a BNSH view of a
    BTNH-contiguous buffer."""
    batch, heads, seq_q, head_dim = dq_acc.shape
    dq = torch.empty((batch, seq_q, heads, head_dim), dtype=dtype, device=dq_acc.device).transpose(1, 2)
    fn = _kernel("flash_bwd", "flash_bwd_dq_emit",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dq_acc.device):
        _launch(
            fn, dq_acc.data_ptr(), _ptr(rope_cos), _ptr(rope_sin), dq.data_ptr(), batch, heads, seq_q, head_dim,
            _DTYPE_CODES[dtype], *dq.stride()[:3], rope_sn, scale, _stream(dq_acc.device),
        )
    flash_bwd_dq_emit.launches += 1
    return dq


flash_bwd_dq_emit.launches = 0


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
    caller-given natural-log `lse` (B, N, Sq) fp32 and the output gradient `do`;
    with FINETRAINERS_FLASH_FUSED_BWD=1, K5 and its dq emit instead.

    Takes what K1 takes (bf16/fp16, H in {64, 128}, any sequence lengths,
    `kv_lens`, fused RoPE from (N or 1, S, H) fp32 tables with Sq == Skv).
    delta = rowsum(dO * out) in fp32 is computed here in plain PyTorch unless
    given. dq, dk, dv are BNSH views of BTNH-contiguous buffers."""
    fused = _switch("FINETRAINERS_FLASH_FUSED_BWD")
    if q.device.type == "cpu":
        reference = flash_backward_fused_reference if fused else flash_backward_reference
        return reference(q, k, v, out, lse, do, kv_lens, rope_cos, rope_sin, scale, delta)
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
    q_s, k_r = flash_qk_prep(q, k, rope_cos, rope_sin, rope_sn, scale)
    if fused:
        dq_acc, dk, dv = flash_bwd_fused(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn)
        return flash_bwd_dq_emit(dq_acc, rope_cos, rope_sin, rope_sn, scale, q.dtype), dk, dv
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


def kernel_tables(query, key, rope_cos, rope_sin):
    """BTNH entry points' RoPE tables, (S, N*H) full-inner-dim (LTX) or (S, H)
    shared across heads, as the kernels take them: (N, S, H) or (1, S, H)
    contiguous. They need Sq == Skv. (None, None) passes through."""
    if rope_cos is None:
        return None, None
    _, q_len, num_heads, head_dim = query.shape
    if q_len != key.shape[1]:
        raise ValueError("fused RoPE requires self-attention shapes")
    if tuple(rope_cos.shape) == (q_len, num_heads * head_dim):
        return tuple(t.reshape(q_len, num_heads, head_dim).transpose(0, 1).contiguous() for t in (rope_cos, rope_sin))
    if tuple(rope_cos.shape) == (q_len, head_dim):
        return rope_cos[None].contiguous(), rope_sin[None].contiguous()
    raise ValueError(
        f"rope tables must be (S, N*H) or (S, H); got {tuple(rope_cos.shape)} "
        f"for S={q_len}, N={num_heads}, H={head_dim}"
    )


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
    rope_cos, rope_sin = kernel_tables(query, key, rope_cos, rope_sin)
    scale = query.shape[-1]**-0.5 if scale is None else float(scale)
    out = FlashAttentionFunction.apply(query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2), kv_lens,
                                       rope_cos, rope_sin, scale)
    return out.transpose(1, 2)
