"""Flash attention on the H100: K1 (forward) and its variants K7a-c, K2/K3
(backward) and the fused backward K5, the pre-pass they share, and the
autograd glue K4, each kernel beside its plain PyTorch version.

Counterpart of `finetrainers_tpu/ops/flash_attention.py`: the Pallas
`_fwd_kernel`, `_fwd_kernel_twopass`, `_fwd_kernel`'s `two_level` branch and
`_fwd_kernel_skew` become the wgmma/TMA kernels in `csrc/flash_fwd_sm90.cu`
(K1, K7a, K7c, K7b); `_bwd_dkdv_kernel`, `_bwd_dq_kernel` and
`_bwd_fused_kernel` become the wgmma/TMA kernels in `csrc/flash_bwd_sm90.cu`
(K2, K3, K5), and `csrc/flash_bwd.cu` holds K5's dq emit and the pre-pass
that rotates and scales q and k once per call for every kernel but K7b; all
are built by `ops/_build.py`.

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
    them, the counterpart of the `jax.custom_vjp` `_flash_mha`. Under a
    dispatch mode its forward is the dispatcher op
    `finetrainers_torch::flash_mha`, so a selective checkpointing policy can
    save its outputs.
  - `flash_attention(query, key, value, ...)` is the BTNH interface of the JAX
    package's `flash_attention`, including its RoPE table conventions; it goes
    through K4 on every device, so its backward is K2/K3 or K5 (or their plain
    versions on the CPU), never autograd through the forward's math.
  - The branches: `flash_forward` and
    `flash_backward` take `causal` (key j <= i + Skv - Sq), segment ids
    `q_seg`/`kv_seg` (packed sequences; -1 pads) and a dense `mask` (kv_lens,
    the flag and the ids folded into it), as JAX's `_flash_forward` and
    `_flash_backward` do, and launch the causal, segment or mask branch of
    the kernel the switches pick, wherever JAX's Pallas kernel has it: K1's,
    K2's and K3's (`csrc/flash_fwd_branches_sm90.cu`,
    `csrc/flash_bwd_branches_sm90.cu`), K7c's and the segment branches of K7a
    and K7b (`csrc/flash_fwd_variant_branches_sm90.cu`), K5's
    (`csrc/flash_bwd_fused_branches_sm90.cu`), all built from the straight
    kernels' sources: the same kernels with a select on each score and loops
    that skip the tiles with no live pair (per-tile id ranges for segments,
    `segment_blocks`; the mask's block map, `mask_tiles`/`mask_tiles_bwd`).
    K1's mask branch alone on the pre-pass's operands is
    `flash_forward_masked_core`. Every kernel and branch takes head dims
    32, 64 and 128 (`HEAD_DIMS`).
  - `flash_attention_reference` / `flash_backward_reference` are the plain
    fp32 math of the kernels: the same base-2 softmax, cast points, masking and
    natural-log LSE. `flash_attention_reference` is the plain pre-pass
    (`flash_qk_prep_reference`) followed by K1's plain version
    (`flash_forward_core_reference`); `flash_backward_reference` is the plain
    pre-pass followed by K2's and K3's (`flash_bwd_dkdv_reference`,
    `flash_bwd_dq_reference`). The `*_twopass`, `*_skew`, `*_two_level`
    and `flash_backward_fused_reference` versions follow their kernel's
    recurrence over kv tiles of the kernel's width (128 keys; K7b's score
    tiles are 64), so their fp32 sums run in the kernel's tile order; they
    take the branches' inputs as `flash_attention_reference` does.

Each kernel wrapper keeps a `launches` count (`flash_qk_prep`,
`flash_forward_two_level`, `flash_forward_twopass`, `flash_forward_skew`,
`flash_bwd_dkdv`, `flash_bwd_dq`, `flash_bwd_fused`, `flash_bwd_dq_emit`; K1's
launches, from `flash_forward` or `flash_forward_core`, count on
`flash_forward`, its mask branch's on `flash_forward_masked_core`) of kernel
launches, never of reference calls, so a run can show that its attention went
through the kernels; `flash_forward`, the three K7 wrappers, `flash_bwd_dkdv`,
`flash_bwd_dq` and `flash_bwd_fused` also count their branches' launches by
branch (`branch_launches`, within `launches`), and `flash_bwd_dkdv` the
launches that ran its reduce pass (`reduce_launches`).
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
# The head dims every kernel and branch takes (K1-K3, K5 and its dq emit,
# K7a/b/c, the pre-pass, and in ops/sage_attention.py K6 and its pre-pass), as
# the JAX package's BlockSpecs run over them: 32 (the dummy family), 64, 128.
HEAD_DIMS = (32, 64, 128)
# A live key tile's entry in the mask branch's lists carries this bit where
# its whole (q tile, key tile) block is unmasked (`csrc/flash_fwd_sm90.cu`).
_MASK_FULL_TILE = 1 << 30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
_SM90_BLOCK_KV = 128  # the kv tile of the wgmma K7a, K7c and K5 (a K5 CTA's kv rows)
_SKEW_BLOCK_KV = 64  # K7b's score tile, half a stage of its 128-key ring
_BWD_ROWS = 128  # kv rows of a K2 CTA (csrc/flash_bwd_sm90.cu)
_BWD_BLOCK_Q = 64  # K2's streamed q tile
_MAX_DKDV_SPLITS = 8


def _switch(name: str) -> bool:
    """Whether the JAX package's switch `name` is set to "1", read per call."""
    return os.environ.get(name, "0") == "1"


def forward_variant(has_rope: bool, causal: bool = False, has_mask: bool = False):
    """The forward variant the switches pick for a call (`_flash_forward`'s gates,
    :724-733, :816): `flash_forward_skew` (never with RoPE tables, a causal flag
    or a dense mask), then `flash_forward_twopass` (never causal or masked),
    then `flash_forward_two_level`, else None (K1 or its branches)."""
    if _switch("FINETRAINERS_FLASH_SKEW") and not (has_rope or causal or has_mask):
        return flash_forward_skew
    if _switch("FINETRAINERS_FLASH_TWOPASS") and not (causal or has_mask):
        return flash_forward_twopass
    if _switch("FINETRAINERS_FLASH_TWOLEVEL"):
        return flash_forward_two_level
    return None


def branch_of(causal: bool, q_seg, mask) -> Optional[str]:
    """The kernel branch a call takes: "mask" (kv_lens, the causal flag and
    segment ids folded into the mask), "segment", "causal", or None."""
    if mask is not None:
        return "mask"
    if q_seg is not None:
        return "segment"
    return "causal" if causal else None


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


def live_pairs(batch, seq_q, seq_kv, device, kv_lens=None, causal=False, q_seg=None, kv_seg=None, mask=None):
    """(B, 1, Sq or 1, Skv) boolean: whether query i attends key j. Key j <
    kv_lens[b]; with `causal`, j <= i + (Skv - Sq) (`_fwd_kernel` :205-209);
    with segment ids (B, Sq) and (B, Skv) int, q_seg[b, i] == kv_seg[b, j]
    (:210-214; -1 marks padding, which matches -1); with a (B, Sq, Skv)
    boolean `mask`, mask[b, i, j]. Every given condition holds."""
    live = _valid_keys(kv_lens, batch, seq_kv, device)
    if causal:
        live = live & torch.ones(seq_q, seq_kv, dtype=torch.bool, device=device).tril(seq_kv - seq_q)
    if q_seg is not None:
        live = live & (q_seg.to(device)[:, None, :, None] == kv_seg.to(device)[:, None, None, :])
    if mask is not None:
        live = live & mask.to(device)[:, None]
    return live


def fold_into_mask(mask, kv_lens=None, causal=False, q_seg=None, kv_seg=None):
    """`mask` (B, Sq, Skv) boolean with kv_lens, the causal flag and segment
    ids folded in (`live_pairs`), as the mask branches take them; the mask
    itself where there is nothing to fold."""
    if kv_lens is None and not causal and q_seg is None:
        return mask
    batch, seq_q, seq_kv = mask.shape
    return live_pairs(batch, seq_q, seq_kv, mask.device, kv_lens, causal, q_seg, kv_seg, mask)[:, 0].contiguous()


def check_branches(causal, q_seg, kv_seg) -> None:
    """JAX `flash_attention`'s rules (:1609-1612): both segment id arrays or
    neither, and no causal flag beside them (per-segment causal restarts are
    not supported)."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given together")
    if q_seg is not None and causal:
        raise NotImplementedError("per-segment causal masking is not supported")


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
    causal: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 version of K1 (`flash_forward_core`) and its causal, segment
    and mask branches on the pre-pass's operands: q_s (B, N, Sq, H) already
    rotated, scaled by scale * log2e and rounded; k_r (B, N, Skv, H) rotated
    and rounded; v (B, N, Skv, H) in the output dtype; kv_lens (B,) ints; the
    branches' inputs as `live_pairs` takes them. Base-2 softmax over the live
    pairs only. Returns out in v's dtype and the (B, N, Sq) fp32 natural-log
    LSE; a row with no live key gives 0 and -1e30*ln2."""
    live = live_pairs(q_s.shape[0], q_s.shape[2], k_r.shape[2], q_s.device, kv_lens, causal, q_seg, kv_seg, mask)
    return _attend(q_s, k_r, v, live, v.dtype)


def _attend(q_s, k_r, v, live, dtype):
    """K1's plain math on the pre-pass's operands over the `live_pairs`, the
    output rounded to `dtype`."""
    s = q_s.float() @ k_r.float().transpose(-1, -2)  # base-2 logits
    s = s.masked_fill(~live, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * live
    return _finish(p @ v.float(), m, p.sum(dim=-1, keepdim=True), dtype)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 version of `flash_forward` (the pre-pass, then K1 or its
    causal, segment or mask branch). q: (B, N, Sq, H); k, v: (B, N, Skv, H);
    kv_lens: (B,) ints; rope tables: (N or 1, S, H) fp32; the branches' inputs
    as `live_pairs` takes them. Returns out in q's dtype and the (B, N, Sq)
    fp32 natural-log LSE. Like the kernels, the rotated and scaled q and the
    rotated k are rounded to the input dtype before QK^T."""
    scale = q.shape[-1]**-0.5 if scale is None else scale
    qs, kr = flash_qk_prep_reference(q, k, rope_cos, rope_sin, scale)
    live = live_pairs(q.shape[0], q.shape[2], k.shape[2], q.device, kv_lens, causal, q_seg, kv_seg, mask)
    return _attend(qs, kr, v, live, q.dtype)


def k1_block_m(head_dim: int) -> int:
    """K1's q rows per CTA: 64 per consumer warpgroup, two at H=128, three below."""
    return 128 if head_dim == 128 else 192


def _tile_lists(live: torch.Tensor, full: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per cell of (B, cells, n) block maps, the live tile indices in order,
    each with `_MASK_FULL_TILE` set where its block needs no select, (B,
    cells, n) int32 with the unused tail after them, and their counts (B,
    cells) int32."""
    order = torch.argsort((~live).to(torch.uint8), dim=-1, stable=True)
    tiles = (order + full.gather(-1, order).to(order.dtype) * _MASK_FULL_TILE).to(torch.int32)
    return tiles.contiguous(), live.sum(dim=-1, dtype=torch.int32)


def _padded_mask(mask: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The (B, Sq, Skv) boolean mask as uint8, zero-padded to (B, rows, cols)."""
    padded = torch.zeros((mask.shape[0], rows, cols), dtype=torch.uint8, device=mask.device)
    padded[:, :mask.shape[1], :mask.shape[2]] = mask
    return padded


def _mask_blocks(padded: torch.Tensor, block_q: int, block_kv: int):
    """(live, full) (B, q tiles, key tiles) maps of a padded uint8 mask: a
    block is live where any byte is set (the JAX block map's occupancy,
    `_prepare_mask`, at the kernel's tiles) and full where every byte is."""
    batch, rows, cols = padded.shape
    blocks = padded.view(batch, rows // block_q, block_q, cols // block_kv, block_kv)
    return blocks.amax(dim=(2, 4)) > 0, blocks.amin(dim=(2, 4)) > 0


def mask_tiles(mask: torch.Tensor, head_dim: int, block_m: Optional[int] = None):
    """The mask branch's operands (K1's, or K7c's with its `block_m` of 128)
    from a (B, Sq, Skv) boolean mask, at the kernel's tile sizes (`k1_block_m`
    q rows unless given, 128 keys): the mask as uint8, zero-padded to whole
    tiles; per (b, q tile) the live key tiles in order, each index with
    `_MASK_FULL_TILE` set where its block is unmasked throughout, (B, nq, nk)
    int32, the unused tail after them; and their counts, (B, nq) int32."""
    batch, seq_q, seq_kv = mask.shape
    block_m = k1_block_m(head_dim) if block_m is None else block_m
    padded = _padded_mask(mask, -(-seq_q // block_m) * block_m, -(-seq_kv // _SM90_BLOCK_KV) * _SM90_BLOCK_KV)
    return (padded, *_tile_lists(*_mask_blocks(padded, block_m, _SM90_BLOCK_KV)))


def mask_tiles_bwd(mask: torch.Tensor):
    """K2's and K3's mask-branch operands from a (B, Sq, Skv) boolean mask:
    K2's, the mask transposed (B, Skv, Sq) and zero-padded to whole tiles of
    128 keys and 64 q rows, with per (b, key tile) its live q tiles (64 rows;
    the tail after them unused) and their counts; K3's, the mask padded to
    whole tiles of 128 q rows and 128 keys, with per (b, q tile) its live key
    tiles and counts. Entries carry `_MASK_FULL_TILE` as in `mask_tiles`."""
    batch, seq_q, seq_kv = mask.shape
    padded = _padded_mask(mask, -(-seq_q // _BWD_ROWS) * _BWD_ROWS, -(-seq_kv // _SM90_BLOCK_KV) * _SM90_BLOCK_KV)
    live, full = _mask_blocks(padded, _BWD_BLOCK_Q, _SM90_BLOCK_KV)
    k2 = (padded.transpose(1, 2).contiguous(), *_tile_lists(live.transpose(1, 2), full.transpose(1, 2)))
    return k2, (padded, *_tile_lists(*_mask_blocks(padded, _BWD_ROWS, _SM90_BLOCK_KV)))


def _id_ranges(ids: torch.Tensor, valid: torch.Tensor, block: int):
    """Per tile of `block` entries of (B, S) ids, the (min, max) over the
    valid entries, int64; a tile with none gets an empty range (min > max)."""
    batch, seq = ids.shape
    tiles = -(-seq // block)
    big = torch.iinfo(torch.int64).max // 2
    lo = torch.full((batch, tiles * block), big, dtype=torch.int64, device=ids.device)
    hi = torch.full((batch, tiles * block), -big, dtype=torch.int64, device=ids.device)
    lo[:, :seq] = torch.where(valid, ids.long(), big)
    hi[:, :seq] = torch.where(valid, ids.long(), -big)
    return lo.view(batch, tiles, block).amin(-1), hi.view(batch, tiles, block).amax(-1)


def segment_blocks(q_seg, kv_seg, kv_lens, block_q: int, block_kv: int = _SM90_BLOCK_KV):
    """(live, full) (B, q tiles, key tiles) maps for segment ids (B, Sq) and
    (B, Skv), keys at or past kv_lens[b] left out: a block is live where the
    q tile's id range [min, max] meets the key tile's (no id can match
    otherwise, whatever the layout, so the skip is exact) and full where both
    tiles hold one and the same id."""
    batch, seq_kv = kv_seg.shape
    q_lo, q_hi = _id_ranges(q_seg, torch.ones_like(q_seg, dtype=torch.bool), block_q)
    k_lo, k_hi = _id_ranges(kv_seg, _valid_keys(kv_lens, batch, seq_kv, kv_seg.device)[:, 0, 0], block_kv)
    live = (q_lo[:, :, None] <= k_hi[:, None, :]) & (k_lo[:, None, :] <= q_hi[:, :, None])
    full = live & (q_lo == q_hi)[:, :, None] & (k_lo == k_hi)[:, None, :] & (q_lo[:, :, None] == k_lo[:, None, :])
    return live, full


def _padded_ids(ids: torch.Tensor, multiple: int) -> torch.Tensor:
    """(B, S) ids as contiguous int32, zero-padded to a multiple of `multiple`
    (the kernels read whole tiles; the padding is never selected)."""
    batch, seq = ids.shape
    out = torch.zeros((batch, -(-seq // multiple) * multiple), dtype=torch.int32, device=ids.device)
    out[:, :seq] = ids
    return out


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
    causal: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain fp32 version of `flash_backward` (the pre-pass, then K2 and K3 or
    their causal, segment or mask branches; BNSH, shapes as `flash_forward`;
    lse natural-log (B, N, Sq) fp32). Rounds where the kernels and
    `_flash_backward` round: q_s and k_r as in the forward; p to the input
    dtype before the dv product; ds = T(p * T(dp - delta)); delta = rowsum(dO
    * out) in fp32 over the rounded `out` unless given; dk = rope^T(ln2 * ds^T
    q_s) and dq = rope^T(scale * ds k_r) in fp32, then rounded. Pairs that are
    not live (`live_pairs`) are selected to p = ds = 0, so a row with no live
    key (an LSE of -1e30*ln2, where exp2 overflows) adds nothing to dk and dv
    and gets dq = 0. Returns (dq, dk, dv) in the input dtypes."""
    scale = q.shape[-1]**-0.5 if scale is None else scale
    qs, kr = flash_qk_prep_reference(q, k, rope_cos, rope_sin, scale)
    if delta is None:
        delta = (do.float() * out.float()).sum(-1)
    branches = dict(causal=causal, q_seg=q_seg, kv_seg=kv_seg, mask=mask)
    dk, dv = flash_bwd_dkdv_reference(qs, kr, v, do, lse, delta, kv_lens, rope_cos, rope_sin, **branches)
    dq = flash_bwd_dq_reference(qs, kr, v, do, lse, delta, kv_lens, rope_cos, rope_sin, scale, **branches)
    return dq, dk, dv


def _bwd_scores(q_s, k_r, v, do, lse, delta, live):
    """(p, ds) of the backward for q rows `q_s`/`do`/`lse`/`delta` against all
    keys, (B, N, Sq, Skv) fp32 at the kernels' rounding points (T = v's dtype),
    both selected to 0 where `live` (broadcast to (B, 1, Sq, Skv)) is False."""
    dtype = v.dtype
    s = q_s.float() @ k_r.float().transpose(-1, -2)
    p = torch.exp2(s - (lse * _LOG2E)[..., None]).to(dtype).float()
    p = torch.where(live, p, torch.zeros_like(p))
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta[..., None]).to(dtype).float()).to(dtype).float()
    return p, torch.where(live, ds, torch.zeros_like(ds))


def flash_bwd_dkdv_reference(q_s, k_r, v, do, lse, delta, kv_lens=None, rope_cos=None, rope_sin=None, splits=1,
                             causal=False, q_seg=None, kv_seg=None, mask=None):
    """Plain version of K2 (`flash_bwd_dkdv`) and its causal, segment and mask
    branches on the pre-pass's operands (q_s, k_r as
    `flash_forward_core_reference` takes them; v, do in the input dtype; lse,
    delta (B, N, Sq) fp32; the branches' inputs as `live_pairs` takes them):
    dk = T(rope^T(ln2 * ds^T q_s)) with k's tables and dv = T(p^T dO) over the
    live pairs, 0 at keys no query attends. With `splits` > 1 the q rows are
    cut as K2 cuts its q loop for cross-attention (whole q tiles,
    `dkdv_splits`): each range's fp32 partial sums are taken alone and then
    added, as K2's reduce pass adds them."""
    dtype = v.dtype
    batch, _, seq_q, _ = q_s.shape
    seq_kv = k_r.shape[2]
    live = live_pairs(batch, seq_q, seq_kv, q_s.device, kv_lens, causal, q_seg, kv_seg, mask)
    live = live.expand(batch, 1, seq_q, seq_kv)
    q_tiles = -(-seq_q // _BWD_BLOCK_Q)
    rows = -(-q_tiles // splits) * _BWD_BLOCK_Q  # whole q tiles per range
    dk = dv = 0.0
    for q0 in range(0, seq_q, rows):
        part = slice(q0, q0 + rows)
        p, ds = _bwd_scores(q_s[:, :, part], k_r, v, do[:, :, part], lse[:, :, part], delta[:, :, part],
                            live[:, :, part])
        dv = dv + p.transpose(-1, -2) @ do[:, :, part].float()
        dk = dk + ds.transpose(-1, -2) @ q_s[:, :, part].float()
    dk = dk * _LN2
    if rope_cos is not None:
        dk = _rope_bwd(dk, rope_cos, rope_sin)
    return dk.to(dtype), dv.to(dtype)


def flash_bwd_dq_reference(q_s, k_r, v, do, lse, delta, kv_lens=None, rope_cos=None, rope_sin=None, scale=None,
                           causal=False, q_seg=None, kv_seg=None, mask=None):
    """Plain version of K3 (`flash_bwd_dq`) and its branches on the pre-pass's
    operands (arguments as `flash_bwd_dkdv_reference`): dq = T(rope^T(scale *
    ds k_r)) with q's tables over the live pairs; a row with no live key gets 0."""
    scale = q_s.shape[-1]**-0.5 if scale is None else scale
    live = live_pairs(q_s.shape[0], q_s.shape[2], k_r.shape[2], q_s.device, kv_lens, causal, q_seg, kv_seg, mask)
    _, ds = _bwd_scores(q_s, k_r, v, do, lse, delta, live)
    dq = (ds @ k_r.float()) * scale
    if rope_cos is not None:
        dq = _rope_bwd(dq, rope_cos, rope_sin)
    return dq.to(v.dtype)


def _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, block, causal=False, q_seg=None, kv_seg=None, mask=None):
    """(q_s, [(k_r tile, v tile, live tile) for each `block`-key tile]) for the
    tiled plain versions: a live tile is the (B, 1, Sq or 1, block) slice of
    the branch's `live_pairs` (the valid keys alone without a branch); the
    tiles are fp32 except v, kept in its dtype."""
    batch, _, seq_q, head_dim = q.shape
    scale = head_dim**-0.5 if scale is None else scale
    qs, kr = flash_qk_prep_reference(q, k, rope_cos, rope_sin, scale)
    live = live_pairs(batch, seq_q, k.shape[2], q.device, kv_lens, causal, q_seg, kv_seg, mask)
    return qs, [(kr[:, :, k0:k0 + block], v[:, :, k0:k0 + block], live[..., k0:k0 + block])
                for k0 in range(0, k.shape[2], block)]


def _pv(p: torch.Tensor, v_tile: torch.Tensor) -> torch.Tensor:
    """p v with p rounded to v's dtype first, as the kernels feed their P V product."""
    return p.to(v_tile.dtype).float() @ v_tile.float()


def _running_state(q):
    batch, heads, seq_q, head_dim = q.shape
    m = torch.full((batch, heads, seq_q, 1), _NEG_INF, device=q.device)
    return m, torch.zeros_like(m), torch.zeros((batch, heads, seq_q, head_dim), device=q.device)


def flash_forward_two_level_reference(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None, causal=False,
                                      q_seg=None, kv_seg=None, mask=None):
    """Plain version of K7c (`_fwd_kernel`'s `two_level` branch) and its
    causal, segment and mask branches: per 128-key tile, p = exp2(s - m_cur)
    against the tile's own max, beta = exp2(m_cur - m_new), l = l*alpha +
    rowsum(p)*beta, acc = acc*alpha + (p v)*beta, with pairs that are not live
    selected to s = -1e30 and p = 0 (a row with no live key in a tile then
    adds nothing; with none at all it gives 0 and -1e30*ln2). Arguments and
    result as `flash_attention_reference`."""
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _SM90_BLOCK_KV, causal, q_seg, kv_seg, mask)
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


def flash_forward_twopass_reference(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None, causal=False,
                                    q_seg=None, kv_seg=None, mask=None):
    """Plain version of K7a (`_fwd_kernel_twopass`) and its segment branch: a
    first sweep over the 128-key tiles takes the row max over the live pairs;
    a second accumulates p = exp2(s - m) against that final max with no
    rescale (p selected to 0 where the pair is not live). Arguments and result
    as `flash_attention_reference` (JAX gates causal and masked calls off
    K7a; the plain version takes them all the same)."""
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _SM90_BLOCK_KV, causal, q_seg, kv_seg, mask)
    m, l, acc = _running_state(q)
    for kr, _, valid in tiles:
        m = torch.maximum(m, (qs @ kr.transpose(-1, -2)).masked_fill(~valid, _NEG_INF).amax(dim=-1, keepdim=True))
    for kr, vt, valid in tiles:
        s = (qs @ kr.transpose(-1, -2)).masked_fill(~valid, _NEG_INF)
        p = torch.where(valid, torch.exp2(s - m), torch.zeros_like(s))
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + _pv(p, vt)
    return _finish(acc, m, l, q.dtype)


def flash_forward_skew_reference(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None, causal=False,
                                 q_seg=None, kv_seg=None, mask=None):
    """Plain version of K7b (`_fwd_kernel_skew`) and its segment branch: K1's
    online-softmax step on each 64-key tile in turn, after a first step on a
    dummy tile of 2*(-1e30) (p = 0, alpha = 1); pairs that are not live are
    selected to -1e30 and recovered from the stored scores (`s > 0.5 *
    -1e30`). Arguments and result as `flash_attention_reference`."""
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _SKEW_BLOCK_KV, causal, q_seg, kv_seg, mask)
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
    causal: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5 (`_bwd_fused_kernel`) and its causal, segment and
    mask branches: `flash_backward_reference`'s quantities at its rounding
    points, computed once per 128-key tile (a K5 CTA's kv rows), with each
    tile's ds k_r added into an fp32 dq accumulator, as K5 adds them; p and
    ds selected to 0 where the pair is not live. Arguments and result as
    `flash_backward_reference`."""
    dtype = q.dtype
    scale = q.shape[-1]**-0.5 if scale is None else scale
    qs, tiles = _kv_tiles(q, k, v, kv_lens, rope_cos, rope_sin, scale, _SM90_BLOCK_KV, causal, q_seg, kv_seg, mask)
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
    """The checks every flash kernel shares. Returns kv_lens as contiguous
    int32 (or None) and the tables' per-head stride (0 for one table shared by
    every head)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{fn}: q, k, v must be (B, N, S, H)")
    batch, heads, seq_q, head_dim = q.shape
    seq_kv = k.shape[2]
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {head_dim} not in {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: the kernel takes bf16 or fp16, got {q.dtype}")
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


def _sm90_forward(entry, q_s, k_r, v, kv_lens, q_scale=None, library="flash_fwd_sm90"):
    """Launch `entry` of `csrc/flash_fwd_sm90.cu` on checked operands -> (out,
    lse): `flash_fwd_sm90` (K1), `flash_fwd_twopass_sm90` (K7a) or
    `flash_fwd_two_level_sm90` (K7c) on the pre-pass's q_s and k_r, or
    `flash_fwd_skew_sm90` (K7b) on the raw q and k with its `q_scale` (scale *
    log2e). The caller counts the launch."""
    batch, heads, seq_q, head_dim = q_s.shape
    out = _btnh_like(q_s)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q_s.device)
    scale_arg = [] if q_scale is None else [ctypes.c_float]
    fn = _kernel(library, entry, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64)] + scale_arg + [ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(kv_lens),
            batch, heads, seq_q, k_r.shape[2], head_dim, _DTYPE_CODES[q_s.dtype], _strides(q_s, k_r, v, out),
            *([] if q_scale is None else [q_scale]), _stream(q_s.device),
        )
    return out, lse


def _k1(q_s, k_r, v, kv_lens):
    """Launch K1 on checked operands; counted on `flash_forward.launches`."""
    out = _sm90_forward("flash_fwd_sm90", q_s, k_r, v, kv_lens)
    flash_forward.launches += 1
    return out


def _count_branch(wrapper, branch: str) -> None:
    wrapper.launches += 1
    wrapper.branch_launches[branch] += 1


def _k1_causal(q_s, k_r, v, kv_lens):
    """Launch K1's causal branch on checked operands (K1's arguments, the key
    tiles wholly above the diagonal never loaded); counted on
    `flash_forward.launches` and `flash_forward.branch_launches["causal"]`."""
    out = _sm90_forward("flash_fwd_causal_sm90", q_s, k_r, v, kv_lens, library="flash_fwd_branches_sm90")
    _count_branch(flash_forward, "causal")
    return out


def _check_segments(fn: str, q_seg, kv_seg, batch: int, seq_q: int, seq_kv: int, device) -> None:
    for name, ids, seq in (("q_segment_ids", q_seg, seq_q), ("kv_segment_ids", kv_seg, seq_kv)):
        if tuple(ids.shape) != (batch, seq) or ids.device != device or ids.dtype.is_floating_point:
            raise ValueError(f"{fn}: {name} must be integer ({batch}, {seq}) on {device}, "
                             f"got {ids.dtype} {tuple(ids.shape)} on {ids.device}")


# Segment ids are padded to a multiple of every kernel's q tile (64, 128, 192 rows) and of the 128-key tile.
_SEG_Q_MULTIPLE = 384


def _k1_segment(q_s, k_r, v, kv_lens, q_seg, kv_seg):
    """Launch K1's segment branch on checked operands: per q tile the key
    tiles whose id range meets its own (`segment_blocks`), each score
    selected where the ids differ or the key is at or past kv_lens[b];
    counted on `flash_forward.launches` and `.branch_launches["segment"]`."""
    batch, heads, seq_q, head_dim = q_s.shape
    seq_kv = k_r.shape[2]
    tiles, counts = _tile_lists(*segment_blocks(q_seg, kv_seg, kv_lens, k1_block_m(head_dim)))
    q_ids, kv_ids = _padded_ids(q_seg, _SEG_Q_MULTIPLE), _padded_ids(kv_seg, _SM90_BLOCK_KV)
    out = _btnh_like(q_s)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q_s.device)
    fn = _kernel("flash_fwd_branches_sm90", "flash_fwd_segment_sm90", [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 2
                 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(kv_lens),
            q_ids.data_ptr(), kv_ids.data_ptr(), tiles.data_ptr(), counts.data_ptr(), q_ids.shape[1],
            kv_ids.shape[1], batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q_s.dtype],
            _strides(q_s, k_r, v, out), tiles.shape[1], tiles.shape[2], _stream(q_s.device),
        )
    _count_branch(flash_forward, "segment")
    return out, lse


def flash_forward_core(
    q_s: torch.Tensor,
    k_r: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (or its causal or segment branch) alone, on the pre-pass's operands
    (see `flash_forward_core_reference`) -> (out, lse); `flash_forward` is the
    pre-pass followed by this. On a CPU tensor the plain version; on a CUDA
    tensor the kernel, after the checks of `flash_forward`, or it raises.
    Launches count on `flash_forward.launches`."""
    check_branches(causal, q_seg, kv_seg)
    if q_s.device.type == "cpu":
        return flash_forward_core_reference(q_s, k_r, v, kv_lens, causal, q_seg, kv_seg)
    branch = branch_of(causal, q_seg, None)
    kv_lens, _ = _check_kernel_call("flash_forward_core", q_s, k_r, v, kv_lens, None, None)
    if branch == "causal":
        return _k1_causal(q_s, k_r, v, kv_lens)
    if branch == "segment":
        _check_segments("flash_forward_core", q_seg, kv_seg, q_s.shape[0], q_s.shape[2], k_r.shape[2], q_s.device)
        return _k1_segment(q_s, k_r, v, kv_lens, q_seg, kv_seg)
    return _k1(q_s, k_r, v, kv_lens)


def flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass and K1 on BNSH tensors -> (out (B, N, Sq, H) in q's dtype,
    lse (B, N, Sq) fp32), or K7a/b/c where a switch picks them (`forward_variant`).

    The kernel takes bf16 or fp16 with H in {32, 64, 128} and any sequence lengths;
    fused RoPE needs Sq == Skv and (N or 1, S, H) fp32 tables. `causal` keeps
    key j <= i + (Skv - Sq) (K1's causal branch), segment ids (B, Sq), (B, Skv)
    keep pairs of equal ids (K1's segment branch), a (B, Sq, Skv) boolean
    `mask` (True = attend) takes K1's mask branch, with kv_lens, the flag and
    the ids folded in (key tiles whose mask is all False are not read); under
    a switch the picked kernel's branch. A row with no live key gives 0 and an
    LSE of -1e30*ln2. `out` is a BNSH view of a BTNH-contiguous buffer, so
    `out.transpose(1, 2)` is contiguous."""
    check_branches(causal, q_seg, kv_seg)
    variant = forward_variant(rope_cos is not None, causal, mask is not None)
    if variant is not None:
        return variant(q, k, v, kv_lens, rope_cos, rope_sin, scale, causal, q_seg, kv_seg, mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_lens, rope_cos, rope_sin, scale, causal, q_seg, kv_seg, mask)
    branch = branch_of(causal, q_seg, mask)
    kv_lens, rope_sn = _check_kernel_call("flash_forward", q, k, v, kv_lens, rope_cos, rope_sin)
    kv_lens, mask = _check_branch_inputs("flash_forward", q, k, kv_lens, causal, q_seg, kv_seg, mask)
    scale = q.shape[-1]**-0.5 if scale is None else float(scale)
    q_s, k_r = flash_qk_prep(q, k, rope_cos, rope_sin, rope_sn, scale)
    if branch == "mask":
        return _k1_masked(q_s, k_r, v, mask)
    if branch == "causal":
        return _k1_causal(q_s, k_r, v, kv_lens)
    if branch == "segment":
        return _k1_segment(q_s, k_r, v, kv_lens, q_seg, kv_seg)
    return _k1(q_s, k_r, v, kv_lens)


flash_forward.launches = 0
flash_forward.branch_launches = {"causal": 0, "segment": 0}  # K1's branches, also counted in `launches`


def _check_mask(fn: str, mask: torch.Tensor, q: torch.Tensor, seq_kv: int) -> torch.Tensor:
    if mask.dtype != torch.bool or tuple(mask.shape) != (q.shape[0], q.shape[2], seq_kv) or mask.device != q.device:
        raise ValueError(f"{fn}: the mask must be boolean ({q.shape[0]}, {q.shape[2]}, {seq_kv}) on {q.device}, "
                         f"got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    return mask


def _check_branch_inputs(fn, q, k, kv_lens, causal, q_seg, kv_seg, mask):
    """A kernel call's branch inputs, checked: (kv_lens, mask), with kv_lens,
    the causal flag and the ids folded into a given mask and kv_lens then
    None, as the mask branches take them."""
    if mask is not None:
        return None, fold_into_mask(_check_mask(fn, mask, q, k.shape[2]), kv_lens, causal, q_seg, kv_seg)
    if q_seg is not None:
        _check_segments(fn, q_seg, kv_seg, q.shape[0], q.shape[2], k.shape[2], q.device)
    return kv_lens, None


# The last mask each kind of tile list was built for ("fwd" at a q tile of
# `block_m` rows, "bwd" for K2, K3 and K5) and its lists: a text tower hands
# every layer the same mask, and a backward the mask its forward saw. An entry
# holds the mask, so its storage cannot pass to another tensor while cached; a call
# reuses the lists where its mask is a view of the same storage, layout and
# version. An inference tensor keeps no version (an in-place write under
# inference mode bumps nothing), so one is compared with a copy kept for it
# instead: one pass on the device and a sync, against the half-dozen passes
# that build the lists.
_MASK_TILES_CACHE = {}


def _cached_tiles(kind, mask: torch.Tensor, build):
    inference = mask.is_inference()
    key = (mask.data_ptr(), mask.device, tuple(mask.shape), tuple(mask.stride()),
           None if inference else mask._version)
    entry = _MASK_TILES_CACHE.get(kind)
    if entry is not None and entry[0] == key:
        _, _, copy, tiles = entry
        if copy is None or torch.equal(copy, mask):
            return tiles
    tiles = build(mask)
    _MASK_TILES_CACHE[kind] = (key, mask, mask.clone() if inference else None, tiles)
    return tiles


def _cached_mask_tiles(mask: torch.Tensor, head_dim: int, block_m: int):
    return _cached_tiles(("fwd", block_m), mask, lambda m: mask_tiles(m, head_dim, block_m))


def _k1_masked(q_s, k_r, v, mask):
    """Launch K1's mask branch on checked operands -> (out, lse); counted on
    `flash_forward_masked_core.launches`."""
    batch, heads, seq_q, head_dim = q_s.shape
    padded, tiles, counts = _cached_mask_tiles(mask, head_dim, k1_block_m(head_dim))
    out = _btnh_like(q_s)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q_s.device)
    fn = _kernel("flash_fwd_branches_sm90", "flash_fwd_mask_sm90", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), padded.data_ptr(),
            tiles.data_ptr(), counts.data_ptr(), batch, heads, seq_q, k_r.shape[2], head_dim,
            _DTYPE_CODES[q_s.dtype], _strides(q_s, k_r, v, out), tiles.shape[1], tiles.shape[2], _stream(q_s.device),
        )
    flash_forward_masked_core.launches += 1
    return out, lse


def flash_forward_masked_core(q_s, k_r, v, mask):
    """K1's mask branch alone, on the pre-pass's operands (as
    `flash_forward_core` takes them) and a (B, Sq, Skv) boolean mask -> (out,
    lse). On a CPU tensor the plain version (`flash_forward_core_reference`
    with `mask`); on a CUDA tensor the kernel, after the checks of
    `flash_forward`, or it raises. Its launches, from here or from
    `flash_forward` with a mask, count on `flash_forward_masked_core.launches`."""
    if q_s.device.type == "cpu":
        return flash_forward_core_reference(q_s, k_r, v, mask=mask)
    _check_kernel_call("flash_forward_masked_core", q_s, k_r, v, None, None, None)
    return _k1_masked(q_s, k_r, v, _check_mask("flash_forward_masked_core", mask, q_s, k_r.shape[2]))


flash_forward_masked_core.launches = 0

# The C codes of the forward variants' steps (`Step` in csrc/flash_fwd_sm90.cu).
_STEP_CODES = {"flash_forward_twopass": 1, "flash_forward_two_level": 2, "flash_forward_skew": 3}


def _variant_block_m(name: str, head_dim: int) -> int:
    """The q rows of a K7 CTA: K7a's are K1's; K7c and K7b run two consumer
    warpgroups at both head dims."""
    return k1_block_m(head_dim) if name == "flash_forward_twopass" else 128


def _variant_branch(name, branch, q_s, k_r, v, kv_lens, q_seg, kv_seg, mask, q_scale):
    """Launch the `branch` of the K7 kernel `name` on checked operands (the
    pre-pass's, or K7b's raw q and k with its q_scale) -> (out, lse): the
    tiles and the select of K1's branch, at the kernel's own q tile. The
    caller counts the launch."""
    batch, heads, seq_q, head_dim = q_s.shape
    seq_kv = k_r.shape[2]
    padded = tiles = counts = q_ids = kv_ids = None
    block_m = _variant_block_m(name, head_dim)
    if branch == "mask":
        padded, tiles, counts = _cached_mask_tiles(mask, head_dim, block_m)
    elif branch == "segment":
        tiles, counts = _tile_lists(*segment_blocks(q_seg, kv_seg, kv_lens, block_m))
        q_ids, kv_ids = _padded_ids(q_seg, _SEG_Q_MULTIPLE), _padded_ids(kv_seg, _SM90_BLOCK_KV)
    out = _btnh_like(q_s)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q_s.device)
    fn = _kernel("flash_fwd_variant_branches_sm90", "flash_fwd_variant_branch_sm90",
                 [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
                 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 2
                 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, _STEP_CODES[name], _BRANCH_CODES[branch], q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _ptr(kv_lens), _ptr(padded), _ptr(q_ids), _ptr(kv_ids),
            0 if q_ids is None else q_ids.shape[1], 0 if kv_ids is None else kv_ids.shape[1], _ptr(tiles),
            _ptr(counts), batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q_s.dtype], _strides(q_s, k_r, v, out),
            0 if tiles is None else tiles.shape[1], 0 if tiles is None else tiles.shape[2],
            1.0 if q_scale is None else q_scale, _stream(q_s.device),
        )
    return out, lse


def _forward_kernel(name, entry, q, k, v, kv_lens, rope_cos, rope_sin, scale, causal, q_seg, kv_seg, mask):
    """Check a forward call and launch `entry` of `csrc/flash_fwd_sm90.cu`
    (`_sm90_forward`), or the K7 kernel's branch (`_variant_branch`): K7a and
    K7c after the pre-pass, on its operands; K7b, which takes no tables, on q
    and k themselves, scaling q in the kernel."""
    kv_lens, rope_sn = _check_kernel_call(name, q, k, v, kv_lens, rope_cos, rope_sin)
    branch = branch_of(causal, q_seg, mask)
    kv_lens, mask = _check_branch_inputs(name, q, k, kv_lens, causal, q_seg, kv_seg, mask)
    scale = q.shape[-1]**-0.5 if scale is None else float(scale)
    q_scale = None
    if entry == "flash_fwd_skew_sm90":
        q_s, k_r, q_scale = q, k, scale * _LOG2E
    else:
        q_s, k_r = flash_qk_prep(q, k, rope_cos, rope_sin, rope_sn, scale)
    if branch is not None:
        return _variant_branch(name, branch, q_s, k_r, v, kv_lens, q_seg, kv_seg, mask, q_scale)
    return _sm90_forward(entry, q_s, k_r, v, kv_lens, q_scale)


def _forward_variant(name: str, entry: str, plain: str, takes_rope: bool, branches, doc: str):
    """A K7 wrapper: on a CPU tensor the plain version named `plain` (looked up
    per call), else the kernel at C entry `entry` or its branch
    (`_forward_kernel`), counted in its own `launches` and, for a branch, in
    `branch_launches`. Without `takes_rope` it refuses RoPE tables; it takes
    the `branches` JAX sends its Pallas kernel (`forward_variant`'s gates)."""

    def wrapper(q, k, v, kv_lens=None, rope_cos=None, rope_sin=None, scale=None, causal=False, q_seg=None,
                kv_seg=None, mask=None):
        if rope_cos is not None and not takes_rope:
            raise ValueError(f"{name}: this kernel takes no RoPE tables")
        check_branches(causal, q_seg, kv_seg)
        branch = branch_of(causal, q_seg, mask)
        if branch is not None and branch not in branches:
            raise ValueError(f"{name}: no {branch} branch (JAX gates such calls off this kernel)")
        if q.device.type == "cpu":
            return globals()[plain](q, k, v, kv_lens, rope_cos, rope_sin, scale, causal, q_seg, kv_seg, mask)
        out = _forward_kernel(name, entry, q, k, v, kv_lens, rope_cos, rope_sin, scale, causal, q_seg, kv_seg, mask)
        wrapper.launches += 1
        if branch is not None:
            wrapper.branch_launches[branch] += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    wrapper.branch_launches = dict.fromkeys(branches, 0)  # also counted in `launches`
    return wrapper


flash_forward_two_level = _forward_variant(
    "flash_forward_two_level", "flash_fwd_two_level_sm90", "flash_forward_two_level_reference", True,
    ("causal", "segment", "mask"),
    "K7c: `flash_forward`'s function through the two-level recurrence, after the pre-pass. Takes what K1 takes, "
    "its causal, segment and mask branches included.")
flash_forward_twopass = _forward_variant(
    "flash_forward_twopass", "flash_fwd_twopass_sm90", "flash_forward_twopass_reference", True, ("segment",),
    "K7a: `flash_forward`'s function in two passes (max, then accumulate), after the pre-pass. Takes what K1 "
    "takes but a causal flag or a mask (JAX gates those off the two-pass kernel).")
flash_forward_skew = _forward_variant(
    "flash_forward_skew", "flash_fwd_skew_sm90", "flash_forward_skew_reference", False, ("segment",),
    "K7b: `flash_forward`'s function, software-pipelined. Takes what K1 takes except RoPE tables, a causal flag "
    "or a mask (the JAX package gates the skewed kernel off them; `flash_forward` sends such calls elsewhere).")


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


_BRANCH_CODES = {"causal": 1, "segment": 2, "mask": 3}
# The branch arguments of K2's and K3's branch entries: the branch, the padded q
# and kv segment ids with their per-batch lengths, the padded mask with its
# batch and row strides, the tile lists with their cells per batch and length.
_BRANCH_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
                    + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2)


def _branch_args(branch, lists, q_seg=None, kv_seg=None):
    """The `_BRANCH_ARGTYPES` values for `branch`; `lists` is (mask or None,
    tiles, counts) at the kernel's own tiles, or None for the causal branch."""
    q_ids = kv_ids = mask = tiles = counts = None
    if branch == "segment":
        q_ids, kv_ids = _padded_ids(q_seg, _SEG_Q_MULTIPLE), _padded_ids(kv_seg, _SM90_BLOCK_KV)
    if lists is not None:
        mask, tiles, counts = lists
    args = [_BRANCH_CODES[branch], _ptr(q_ids), _ptr(kv_ids), 0 if q_ids is None else q_ids.shape[1],
            0 if kv_ids is None else kv_ids.shape[1], _ptr(mask), 0 if mask is None else mask.stride(0),
            0 if mask is None else mask.stride(1), _ptr(tiles), _ptr(counts),
            0 if tiles is None else tiles.shape[1], 0 if tiles is None else tiles.shape[2]]
    return args, (q_ids, kv_ids)  # the padded ids stay alive through the launch


def _bwd_lists(branch, kernel, q_seg, kv_seg, kv_lens, mask):
    """K2's (`kernel` "k2": per key tile its live q tiles of 64 rows, the mask
    transposed) or K3's ("k3": per 128-row q tile its live key tiles) lists
    for the segment or mask branch, else None."""
    if branch == "mask":
        k2, k3 = _cached_tiles("bwd", mask, mask_tiles_bwd)
        return k2 if kernel == "k2" else k3
    if branch == "segment":
        if kernel == "k2":
            live, full = segment_blocks(q_seg, kv_seg, kv_lens, _BWD_BLOCK_Q)
            return (None, *_tile_lists(live.transpose(1, 2), full.transpose(1, 2)))
        return (None, *_tile_lists(*segment_blocks(q_seg, kv_seg, kv_lens, _BWD_ROWS)))
    return None


def flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int, causal=False, q_seg=None,
                   kv_seg=None, mask=None):
    """K2 (or its causal, segment or mask branch: pairs that are not live
    selected to p = ds = 0, q tiles with no live pair skipped) on operands
    `flash_backward` has checked, with q_s/k_r from `flash_qk_prep`: (dk,
    dv), BNSH views of BTNH-contiguous buffers. On a CUDA tensor it launches
    the wgmma kernel of `csrc/flash_bwd_sm90.cu` and, where `dkdv_splits`
    cuts its q loop, the reduce pass that sums the fp32 partials; on a CPU
    tensor it computes `flash_bwd_dkdv_reference`. The mask branch takes
    kv_lens folded into the mask."""
    if q_s.device.type == "cpu":
        return flash_bwd_dkdv_reference(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, causal=causal,
                                        q_seg=q_seg, kv_seg=kv_seg, mask=mask)
    batch, heads, seq_q, head_dim = q_s.shape
    seq_kv = k_r.shape[2]
    dk, dv = _btnh_like(k_r), _btnh_like(v)
    splits, per, partials = _split_q_loop(q_s, k_r)
    branch = branch_of(causal, q_seg, mask)
    entry, extra, keep = "flash_bwd_dkdv_sm90", [], None
    if branch is not None:
        entry = "flash_bwd_dkdv_branch_sm90"
        extra, keep = _branch_args(branch, _bwd_lists(branch, "k2", q_seg, kv_seg, kv_lens, mask), q_seg, kv_seg)
    fn = _kernel("flash_bwd_sm90" if branch is None else "flash_bwd_branches_sm90", entry,
                 _BWD_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                 + (_BRANCH_ARGTYPES if branch is not None else []) + [ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin), dk.data_ptr(), dv.data_ptr(), _ptr(partials),
            batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q_s.dtype], _strides(q_s, k_r, v, do, dk, dv),
            rope_sn, splits, per, *extra, _stream(q_s.device),
        )
    del keep
    if branch is None:
        flash_bwd_dkdv.launches += 1
    else:
        _count_branch(flash_bwd_dkdv, branch)
    flash_bwd_dkdv.reduce_launches += splits > 1
    return dk, dv


flash_bwd_dkdv.launches = 0
flash_bwd_dkdv.branch_launches = {"causal": 0, "segment": 0, "mask": 0}  # also counted in `launches`
flash_bwd_dkdv.reduce_launches = 0  # the launches that also ran the reduce pass


def flash_bwd_dq(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int, scale: float, causal=False,
                 q_seg=None, kv_seg=None, mask=None):
    """K3 (or its causal, segment or mask branch: pairs that are not live
    selected to ds = 0, key tiles with no live pair skipped) on operands
    `flash_backward` has checked, with q_s/k_r from `flash_qk_prep`: dq, a
    BNSH view of a BTNH-contiguous buffer. On a CUDA tensor it launches the
    wgmma kernel of `csrc/flash_bwd_sm90.cu`; on a CPU tensor it computes
    `flash_bwd_dq_reference`."""
    if q_s.device.type == "cpu":
        return flash_bwd_dq_reference(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, scale, causal=causal,
                                      q_seg=q_seg, kv_seg=kv_seg, mask=mask)
    batch, heads, seq_q, head_dim = q_s.shape
    dq = _btnh_like(q_s)
    branch = branch_of(causal, q_seg, mask)
    entry, extra, keep = "flash_bwd_dq_sm90", [], None
    if branch is not None:
        entry = "flash_bwd_dq_branch_sm90"
        extra, keep = _branch_args(branch, _bwd_lists(branch, "k3", q_seg, kv_seg, kv_lens, mask), q_seg, kv_seg)
    fn = _kernel("flash_bwd_sm90" if branch is None else "flash_bwd_branches_sm90", entry,
                 _BWD_ARGTYPES + [ctypes.c_void_p] + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_float]
                 + (_BRANCH_ARGTYPES if branch is not None else []) + [ctypes.c_void_p])
    strides = _strides(q_s, k_r, v, do, dq)
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin), dq.data_ptr(),
            batch, heads, seq_q, k_r.shape[2], head_dim, _DTYPE_CODES[q_s.dtype], strides, rope_sn, scale,
            *extra, _stream(q_s.device),
        )
    del keep
    if branch is None:
        flash_bwd_dq.launches += 1
    else:
        _count_branch(flash_bwd_dq, branch)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.branch_launches = {"causal": 0, "segment": 0, "mask": 0}  # also counted in `launches`


def flash_bwd_fused(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn: int, causal=False, q_seg=None,
                    kv_seg=None, mask=None):
    """K5 (or its causal, segment or mask branch: K2's q tiles and selects,
    dead pairs adding nothing to dk, dv or dq) on operands `flash_backward`
    has checked, with q_s/k_r from `flash_qk_prep`: (dq_acc, dk, dv), dq_acc
    the fp32 (B, N, Sq, H) sum of ds k_r before the scale and the transpose
    rotation (`flash_bwd_dq_emit`), dk and dv BNSH views of BTNH-contiguous
    buffers. It launches the wgmma kernel of `csrc/flash_bwd_sm90.cu` and,
    where `dkdv_splits` cuts its q loop as it cuts K2's, K2's reduce pass;
    dq_acc is zeroed here (rows no live pair reaches stay 0), and the kernel
    adds into it in an order that varies from run to run. The mask branch
    takes kv_lens folded into the mask."""
    batch, heads, seq_q, head_dim = q_s.shape
    seq_kv = k_r.shape[2]
    dk, dv = _btnh_like(k_r), _btnh_like(v)
    dq_acc = torch.zeros((batch, heads, seq_q, head_dim), dtype=torch.float32, device=q_s.device)
    splits, per, partials = _split_q_loop(q_s, k_r)
    branch = branch_of(causal, q_seg, mask)
    entry, extra, keep = "flash_bwd_fused_sm90", [], None
    if branch is not None:
        entry = "flash_bwd_fused_branch_sm90"
        extra, keep = _branch_args(branch, _bwd_lists(branch, "k2", q_seg, kv_seg, kv_lens, mask), q_seg, kv_seg)
    fn = _kernel("flash_bwd_sm90" if branch is None else "flash_bwd_fused_branches_sm90", entry,
                 _BWD_ARGTYPES + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                 + (_BRANCH_ARGTYPES if branch is not None else []) + [ctypes.c_void_p])
    with torch.cuda.device(q_s.device):
        _launch(
            fn, q_s.data_ptr(), k_r.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(kv_lens), _ptr(rope_cos), _ptr(rope_sin), dk.data_ptr(), dv.data_ptr(), _ptr(partials),
            dq_acc.data_ptr(), batch, heads, seq_q, seq_kv, head_dim, _DTYPE_CODES[q_s.dtype],
            _strides(q_s, k_r, v, do, dk, dv), rope_sn, splits, per, *extra, _stream(q_s.device),
        )
    del keep
    if branch is None:
        flash_bwd_fused.launches += 1
    else:
        _count_branch(flash_bwd_fused, branch)
    return dq_acc, dk, dv


flash_bwd_fused.launches = 0
flash_bwd_fused.branch_launches = {"causal": 0, "segment": 0, "mask": 0}  # also counted in `launches`


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
    causal: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 and K3 on BNSH tensors -> (dq, dk, dv), from the forward's `out`, a
    caller-given natural-log `lse` (B, N, Sq) fp32 and the output gradient `do`;
    with FINETRAINERS_FLASH_FUSED_BWD=1, K5 and its dq emit instead.

    Takes what K1 takes (bf16/fp16, H in {32, 64, 128}, any sequence lengths,
    `kv_lens`, fused RoPE from (N or 1, S, H) fp32 tables with Sq == Skv), and
    the causal flag, segment ids or a dense mask as `flash_forward` takes them
    (K2's and K3's branches, or with the fused switch K5's). delta =
    rowsum(dO * out) in fp32 is computed here in plain PyTorch unless given.
    dq, dk, dv are BNSH views of BTNH-contiguous buffers."""
    check_branches(causal, q_seg, kv_seg)
    fused = _switch("FINETRAINERS_FLASH_FUSED_BWD")
    if q.device.type == "cpu":
        plain = flash_backward_fused_reference if fused else flash_backward_reference
        return plain(q, k, v, out, lse, do, kv_lens, rope_cos, rope_sin, scale, delta, causal, q_seg, kv_seg, mask)
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
    kv_lens, mask = _check_branch_inputs("flash_backward", q, k, kv_lens, causal, q_seg, kv_seg, mask)
    if mask is not None:
        causal, q_seg, kv_seg = False, None, None
    scale = head_dim**-0.5 if scale is None else float(scale)
    if delta is None:
        delta = (do.float() * out.float()).sum(-1)
    q_s, k_r = flash_qk_prep(q, k, rope_cos, rope_sin, rope_sn, scale)
    branches = dict(causal=causal, q_seg=q_seg, kv_seg=kv_seg, mask=mask)
    if fused:
        dq_acc, dk, dv = flash_bwd_fused(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn, **branches)
        return flash_bwd_dq_emit(dq_acc, rope_cos, rope_sin, rope_sn, scale, q.dtype), dk, dv
    dk, dv = flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn, **branches)
    dq = flash_bwd_dq(q_s, k_r, v, do, lse, delta, kv_lens, rope_cos, rope_sin, rope_sn, scale, **branches)
    return dq, dk, dv


# K4's forward as one dispatcher op, so that a selective checkpointing policy
# sees it: a kernel launched through ctypes inside an `autograd.Function` is
# invisible at the dispatcher. It is defined with `torch.library.Library` and
# called from `FlashAttentionFunction`, which holds the backward, and only
# while a dispatch mode (the policies') is active: a `torch.library.custom_op`
# with `register_autograd` costs host time on every call, and the dispatcher's
# round trip into Python costs some where nothing looks.
_LIBRARY = torch.library.Library("finetrainers_torch", "DEF")
_LIBRARY.define("flash_mha(Tensor q, Tensor k, Tensor v, Tensor? kv_lens, Tensor? rope_cos, Tensor? rope_sin, "
                "float scale, bool causal=False, Tensor? q_seg=None, Tensor? kv_seg=None, Tensor? mask=None) "
                "-> (Tensor, Tensor)")
_LIBRARY.impl("flash_mha", flash_forward, "CompositeExplicitAutograd")


class FlashAttentionFunction(torch.autograd.Function):
    """K4: flash attention with a kernel backward (the `jax.custom_vjp`
    `_flash_mha`). The forward is `flash_forward` (out and the LSE are fresh
    tensors), through the op `finetrainers_torch::flash_mha` under a dispatch
    mode, and saves q, k, v, out, the LSE and the branches' inputs; the
    backward is `flash_backward` on them. BNSH tensors; kv_lens, the RoPE
    tables, the scale, the causal flag, the segment ids and the mask get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, rope_cos, rope_sin, scale, causal=False, q_seg=None, kv_seg=None, mask=None):
        args = (q, k, v, kv_lens, rope_cos, rope_sin, scale)
        if branch_of(causal, q_seg, mask) is not None:
            args += (causal, q_seg, kv_seg, mask)
        if torch._C._len_torch_dispatch_stack():
            out, lse = torch.ops.finetrainers_torch.flash_mha.default(*args)
        else:
            out, lse = flash_forward(*args)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens, rope_cos, rope_sin, q_seg, kv_seg, mask)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens, rope_cos, rope_sin, q_seg, kv_seg, mask = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, kv_lens, rope_cos, rope_sin, ctx.scale, None, ctx.causal,
                                    q_seg, kv_seg, mask)
        return dq, dk, dv, None, None, None, None, None, None, None, None


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
    attn_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention on BTNH tensors, differentiable through K4 (the JAX
    package's `flash_attention`, with `block_mask` named `attn_mask`).

    query: (B, Sq, N, H); key/value: (B, Skv, Nkv, H) with Nkv dividing N
    (GQA: the kv heads are repeated here, before K4, as JAX repeats them
    outside its `custom_vjp`, so autograd sums the repeat's gradient).
    rope_cos/rope_sin: optional fp32 tables for fused interleaved-pair RoPE,
    either (S, N*H) full-inner-dim (LTX) or (S, H) shared across heads; they
    need Sq == Skv and no GQA. causal: key j <= i + (Skv - Sq). q_segment_ids
    / kv_segment_ids: (B, Sq) / (B, Skv) ints, both or neither, a query
    attends only keys of its own id (-1 marks padding; not with `causal`).
    attn_mask: optional (B, Sq, Skv) boolean (True = attend), the mask
    branches (K1's forward and K2/K3's backward, or the switched kernels'),
    with kv_lens, the causal flag and the ids folded in. A row with no live
    key gives 0 and no gradient."""
    check_branches(causal, q_segment_ids, kv_segment_ids)
    heads, kv_heads = query.shape[2], key.shape[2]
    if kv_heads != heads:
        if rope_cos is not None:
            raise ValueError("fused RoPE requires self-attention shapes without GQA")
        key = key.repeat_interleave(heads // kv_heads, dim=2)
        value = value.repeat_interleave(heads // kv_heads, dim=2)
    scale = query.shape[-1]**-0.5 if scale is None else float(scale)
    if attn_mask is not None:
        attn_mask = fold_into_mask(attn_mask, kv_lens, causal, q_segment_ids, kv_segment_ids)
        kv_lens, causal, q_segment_ids, kv_segment_ids = None, False, None, None
    rope_cos, rope_sin = kernel_tables(query, key, rope_cos, rope_sin)
    args = (query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2), kv_lens, rope_cos, rope_sin, scale)
    if branch_of(causal, q_segment_ids, attn_mask) is not None:  # K4's branch inputs only where a branch runs
        args += (causal, q_segment_ids, kv_segment_ids, attn_mask)
    return FlashAttentionFunction.apply(*args).transpose(1, 2)
