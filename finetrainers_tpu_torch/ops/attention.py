"""Attention provider registry and dispatch (port of `finetrainers_tpu/ops/attention.py`).

Canonical layout is BTNH (batch, seq, heads, head_dim), as in the JAX package.
Providers:

  * "auto" (default): on a CUDA tensor, the hand-written flash kernels
    (`ops/flash_attention.py`) through the autograd function K4: K1 forward,
    K2/K3 backward, for self-attention with fused RoPE and for cross-attention
    with `kv_lens`, on any sequence lengths, with GQA's kv heads repeated
    before K4; `is_causal` takes K1's, K2's and K3's causal branches, and a
    boolean dense mask with no head axis (the text towers' causal and padding
    masks) their mask branches. What they do not take (head-dependent or
    additive masks, dtypes other than bf16/fp16, head dims other than
    32/64/128, or 64/128 under a causal flag or a mask) raises, and never falls
    back to plain math or a library kernel on the card. On a CPU tensor, the
    kernels' plain versions through K4, or `_native_math` for masks, causal and GQA.
  * "flash" / "tpu_flash": K4 only; raises where the kernels do not apply.
  * "flex" (JAX `_flex`): K4 with the mask branches for a boolean or additive
    (0/-inf, read as > -1) mask without a head axis, K4 alone without a mask;
    a head-dependent mask runs `_native_math` on a CPU tensor and raises on a
    CUDA tensor (JAX sends it to XLA).
  * "flash_varlen" (JAX `_flash_varlen`): packed sequences, K4 with segment
    ids (the segment branches); a mask without segment ids or kv_lens is read
    as a padding mask and becomes `kv_lens`, as in JAX (ROADMAP.md section 3,
    finding 26). `attention_dispatch` routes any call with segment ids here.
  * "sage" and its five variant names: the int8 kernel K6 after its
    pre-pass (`ops/sage_attention.py`), forward-only, for serving. A padding
    mask becomes `kv_lens` (finding 26); a dense mask or a causal call takes
    `_native_math` on a CPU tensor and raises on a CUDA tensor. A fused-RoPE
    provider: the pre-pass rotates q and k (in fp32, rounded back to their
    dtype, as the JAX dispatcher rotates them before its kernel) as it
    quantizes them.
  * "_native_math": explicit fp32 softmax, the numerics reference;
    differentiable by autograd through its math; with `dropout_p` and a
    `torch.Generator` (`dropout_rng`) it applies inverted dropout on the
    probabilities.
  * "native": torch SDPA, kept only as a comparison baseline, never the default.
  * "ring" and "ulysses": their single-device branches, K4 and "auto" (one
    card has no context-parallel region, and the parallel degrees above 1
    raise at the command line; queue 1 item 10). Neither rotates in a
    kernel, so the dispatcher rotates q and k before the call, as the JAX
    dispatcher does.

Every other provider name the CLI accepts (`finetrainers_tpu/args.py`) stays
registered and raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..constants import FINETRAINERS_ATTN_CHECKS, FINETRAINERS_ATTN_PROVIDER
from ..logging import get_logger
from .flash_attention import BRANCH_HEAD_DIMS, K1_HEAD_DIMS, _rope_fwd, flash_attention
from .sage_attention import sage_attention

logger = get_logger(__name__)


class AttentionProvider(str, Enum):
    FLASH = "flash"
    SPLASH = "splash"
    RING = "ring"
    NATIVE = "native"
    XLA = "xla"
    _NATIVE_MATH = "_native_math"


class _AttentionProviderRegistry:
    _providers: Dict[str, Callable] = {}
    _active_provider: str = FINETRAINERS_ATTN_PROVIDER

    @classmethod
    def register(cls, name: str):
        def decorator(fn):
            cls._providers[name] = fn
            return fn

        return decorator

    @classmethod
    def get(cls, name: str) -> Callable:
        if name not in cls._providers:
            raise ValueError(f"Unknown attention provider {name!r}. Available: {sorted(cls._providers)}")
        return cls._providers[name]


def list_providers() -> List[str]:
    return sorted(_AttentionProviderRegistry._providers)


def get_active_provider() -> str:
    return _AttentionProviderRegistry._active_provider


@contextlib.contextmanager
def attention_provider(name: str = "native"):
    """Context manager switching the active provider."""
    registry = _AttentionProviderRegistry
    if name not in registry._providers:
        raise ValueError(f"Unknown attention provider {name!r}. Available: {sorted(registry._providers)}")
    old = registry._active_provider
    registry._active_provider = name
    try:
        yield
    finally:
        registry._active_provider = old


def _check_shapes(query, key, value) -> None:
    if query.ndim != 4 or key.ndim != 4 or value.ndim != 4:
        raise ValueError("attention expects BTNH tensors (batch, seq, heads, head_dim)")
    if key.shape[1] != value.shape[1]:
        raise ValueError("key/value sequence lengths differ")
    if query.shape[3] != key.shape[3]:
        raise ValueError("query/key head dims differ")
    if query.shape[2] % key.shape[2] != 0:
        raise ValueError("num query heads must be a multiple of num kv heads (GQA)")


_SAGE_NAMES = ("sage", "sage_varlen", "_sage_qk_int8_pv_fp16_cuda", "_sage_qk_int8_pv_fp16_triton",
               "_sage_qk_int8_pv_fp8_cuda", "_sage_qk_int8_pv_fp8_cuda_sm90")
# Providers that rotate q/k in a kernel (fused interleaved-pair RoPE): K1's and
# K6's pre-passes; everything else gets the rotation applied here before the call.
_FUSED_ROPE_PROVIDERS = frozenset({"auto", "flash", "tpu_flash", "flex", "flash_varlen", *_SAGE_NAMES})


def _rotate_interleaved_4d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotation on (B, S, N, H) with (S, N*H) full-inner-dim tables or (S, H)
    tables shared across heads."""
    _, s, n, h = x.shape
    if tuple(cos.shape) == (s, h):
        cos, sin = cos[:, None, :], sin[:, None, :]
    else:
        cos, sin = cos.reshape(s, n, h), sin.reshape(s, n, h)
    return _rope_fwd(x.float(), cos, sin).to(x.dtype)


def attention_dispatch(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    provider: Optional[str] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    rope_freqs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dropout_rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Single dispatch entry (JAX `attention_dispatch`, :138-226). query/key/value:
    (B, S, N, H). attn_mask: boolean (True = attend) or additive, broadcastable
    to (B, N, Sq, Skv). kv_lens: (B,) valid key lengths. q_segment_ids /
    kv_segment_ids: (B, Sq) / (B, Skv) ints of packed sequences (`pack_sequences`),
    routed to `flash_varlen`. dropout_p: attention dropout, which needs a
    `torch.Generator` as `dropout_rng` and runs `_native_math` (inverted
    dropout on the probabilities); not with segment ids. rope_freqs: optional
    (cos, sin) fp32 tables of shape (S, N*H) or (S, H), interleaved-pair RoPE on
    q and k."""
    name = provider or _AttentionProviderRegistry._active_provider
    if q_segment_ids is not None:
        name = "flash_varlen"  # only the segment branches understand packed ids
    if dropout_p:
        if dropout_rng is None:
            raise ValueError(f"attention dropout_p={dropout_p} needs dropout_rng= (a torch.Generator); flash "
                             "providers do not support dropout")
        if q_segment_ids is not None:
            raise NotImplementedError("attention dropout_p with packed q_segment_ids is not supported: dropout "
                                      "routes to the math provider, which has no segment masking")
        name = "_native_math"
    fn = _AttentionProviderRegistry.get(name)
    if FINETRAINERS_ATTN_CHECKS:
        _check_shapes(query, key, value)
    kwargs = {}
    if q_segment_ids is not None:
        kwargs = {"q_segment_ids": q_segment_ids, "kv_segment_ids": kv_segment_ids}
    if dropout_p:
        kwargs.update(dropout_p=dropout_p, dropout_rng=dropout_rng)
    if rope_freqs is not None:
        fusable = (
            name in _FUSED_ROPE_PROVIDERS
            and query.shape[1] == key.shape[1]
            and query.shape[2] == key.shape[2]
        )
        if fusable:
            kwargs["rope_freqs"] = rope_freqs
        else:
            query = _rotate_interleaved_4d(query, *rope_freqs)
            key = _rotate_interleaved_4d(key, *rope_freqs)
    return fn(query=query, key=key, value=value, attn_mask=attn_mask, is_causal=is_causal,
              scale=scale, kv_lens=kv_lens, **kwargs)


def pack_sequences(seqs, total_len: Optional[int] = None):
    """Pack a list of (S_i, ...) tensors or arrays into one packed row (JAX
    `pack_sequences`, :250-269): (packed (1, total, ...) with zero padding,
    segment ids (1, total) int32 with ids 1..n and -1 on the padding)."""
    seqs = [torch.as_tensor(s) for s in seqs]
    lengths = [s.shape[0] for s in seqs]
    total = sum(lengths)
    total_len = total_len or total
    if total_len < total:
        raise ValueError(f"total_len={total_len} < packed length {total}")
    packed = torch.cat(seqs, dim=0)
    if total_len > total:
        packed = torch.cat([packed, packed.new_zeros((total_len - total, *packed.shape[1:]))], dim=0)
    ids = torch.cat([torch.full((n,), i + 1, dtype=torch.int32) for i, n in enumerate(lengths)]
                    + [torch.full((total_len - total,), -1, dtype=torch.int32)])
    return packed[None], ids[None].to(packed.device)


# ---------------------------------------------------------------------- providers


def _mask_from_kv_lens(kv_lens: torch.Tensor, skv: int) -> torch.Tensor:
    """(B,) -> (B, 1, 1, Skv) boolean mask."""
    col = torch.arange(skv, device=kv_lens.device)[None, :]
    return (col < kv_lens[:, None])[:, None, None, :]


@_AttentionProviderRegistry.register("_native_math")
def _math_attention(query, key, value, attn_mask, is_causal, scale, kv_lens, dropout_p=0.0, dropout_rng=None):
    """Explicit softmax in fp32 (numerics baseline). With `dropout_p` and a
    `torch.Generator` it applies inverted dropout on the probabilities (JAX
    :320-322, torch SDPA's semantics; the draws are torch's, not JAX's)."""
    b, sq, n, h = query.shape
    skv, n_kv = key.shape[1], key.shape[2]
    if n_kv != n:
        key = key.repeat_interleave(n // n_kv, dim=2)
        value = value.repeat_interleave(n // n_kv, dim=2)
    scale = scale if scale is not None else h**-0.5
    q = query.float() * scale
    logits = torch.einsum("bqnh,bknh->bnqk", q, key.float())
    if kv_lens is not None:
        logits = logits.masked_fill(~_mask_from_kv_lens(kv_lens.to(query.device), skv), float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    if is_causal:
        causal = torch.ones((sq, skv), dtype=torch.bool, device=query.device).tril(skv - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if dropout_p and dropout_rng is not None:
        keep = torch.bernoulli(torch.full_like(probs, 1.0 - dropout_p), generator=dropout_rng)
        probs = probs * keep / (1.0 - dropout_p)
    out = torch.einsum("bnqk,bknh->bqnh", probs, value.float())
    return out.to(query.dtype)


@_AttentionProviderRegistry.register("native")
def _sdpa_attention(query, key, value, attn_mask, is_causal, scale, kv_lens):
    """torch SDPA: a comparison baseline only, never on the default path."""
    if kv_lens is not None and attn_mask is None:
        attn_mask = _mask_from_kv_lens(kv_lens.to(query.device), key.shape[1])
    out = F.scaled_dot_product_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        attn_mask=attn_mask, is_causal=is_causal, scale=scale,
        enable_gqa=query.shape[2] != key.shape[2],
    )
    return out.transpose(1, 2)


def _k1_mask(attn_mask: torch.Tensor, batch: int, seq_q: int, seq_kv: int) -> Optional[torch.Tensor]:
    """A boolean mask broadcastable to (B, 1, Sq, Skv) as the (B, Sq, Skv) view
    K1's mask branch takes (a head axis of 1 squeezed, as JAX `_flex`
    squeezes it), or None for a mask the branch does not take: additive, or
    one that depends on the head."""
    if attn_mask.dtype != torch.bool:
        return None
    mask = attn_mask
    if mask.ndim == 4:
        if mask.shape[1] != 1:
            return None
        mask = mask[:, 0]
    if mask.ndim not in (2, 3):
        return None
    try:
        return mask.expand(batch, seq_q, seq_kv)
    except RuntimeError:
        return None


def _k1_takes(query, key, attn_mask, is_causal) -> bool:
    """Whether K1 (or its branches) computes this call. On the CPU: no dense
    mask, not causal, no GQA (the rest goes to `_native_math`, as JAX `auto`
    sends it to XLA). On the card: bf16/fp16, head dim 32, 64 or 128, GQA
    allowed (the kv heads are repeated before K4); causal at head dim 64 or
    128 (the causal branch); with a dense mask, a boolean one without a head
    axis (`_k1_mask`) at head dim 64 or 128 (the causal flag folded into it)."""
    if query.device.type == "cpu":
        return attn_mask is None and not is_causal and query.shape[2] == key.shape[2]
    if query.dtype not in (torch.bfloat16, torch.float16):
        return False
    if attn_mask is None:
        return query.shape[-1] in (BRANCH_HEAD_DIMS if is_causal else K1_HEAD_DIMS)
    return (query.shape[-1] in BRANCH_HEAD_DIMS
            and _k1_mask(attn_mask, query.shape[0], query.shape[1], key.shape[1]) is not None)


@_AttentionProviderRegistry.register("flash")
@_AttentionProviderRegistry.register("tpu_flash")
def _flash(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs=None):
    """K1 only (`tpu_flash` named the JAX in-tree TPU kernel; here it maps to K1).
    On the card a causal call takes the causal branches and a dense mask the
    mask branches; on the CPU `_k1_takes` refuses masks, causal calls and
    GQA, which `auto` sends to fp32 math."""
    if not _k1_takes(query, key, attn_mask, is_causal):
        raise NotImplementedError(
            "K1 takes no head-dependent or additive mask, and on the card only bf16/fp16 with head dim 32, 64 or "
            f"128, and 64 or 128 under a causal flag or a mask (got {query.dtype}, head dim {query.shape[-1]}, "
            f"causal {is_causal}, mask {None if attn_mask is None else (attn_mask.dtype, tuple(attn_mask.shape))}); "
            "see ROADMAP.md queue 2 item 5"
        )
    cos, sin = rope_freqs if rope_freqs is not None else (None, None)
    mask = None if attn_mask is None else _k1_mask(attn_mask, query.shape[0], query.shape[1], key.shape[1])
    return flash_attention(query, key, value, kv_lens=kv_lens, scale=scale, rope_cos=cos, rope_sin=sin,
                           attn_mask=mask, causal=is_causal)


@_AttentionProviderRegistry.register("auto")
def _auto_attention(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs=None):
    """Default provider. A CUDA tensor always goes to K1 (a causal call to its
    causal branch, a dense mask to its mask branch), which raises for what it
    does not take; a CPU tensor goes to K1's plain version where K1 applies
    and to fp32 math otherwise (dense masks, causal, GQA). Both LTX
    attentions take K1."""
    if query.device.type != "cpu" or _k1_takes(query, key, attn_mask, is_causal):
        return _flash(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs)
    return _math_rotated(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs)


def _math_rotated(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs):
    """`_native_math` after the dispatcher's rotation, for what JAX sends to XLA."""
    if rope_freqs is not None:
        query = _rotate_interleaved_4d(query, *rope_freqs)
        key = _rotate_interleaved_4d(key, *rope_freqs)
    return _math_attention(query, key, value, attn_mask, is_causal, scale, kv_lens)


@_AttentionProviderRegistry.register("flex")
def _flex(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs=None):
    """Block-mask attention (JAX `_flex`, :534-558): without a mask K4 (K1-K3,
    their causal branches under `is_causal`); a boolean or additive (0/-inf,
    read as > -1) mask without a head axis K4 with the mask branches, which
    skip the key tiles the mask leaves empty in the forward and both backward
    kernels. A head-dependent mask, which JAX sends to XLA: `_native_math` on
    a CPU tensor, on a CUDA tensor it raises."""
    cos, sin = rope_freqs if rope_freqs is not None else (None, None)
    if attn_mask is None:
        return flash_attention(query, key, value, kv_lens=kv_lens, scale=scale, rope_cos=cos, rope_sin=sin,
                               causal=is_causal)
    mask = attn_mask if attn_mask.dtype == torch.bool else attn_mask > -1.0
    if mask.ndim == 4:
        if mask.shape[1] != 1:
            if query.device.type != "cpu":
                raise NotImplementedError("flex: a head-dependent mask has no kernel (JAX runs XLA's fused "
                                          "attention there); see ROADMAP.md queue 1 item 11")
            return _math_rotated(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs)
        mask = mask[:, 0]
    mask = mask.expand(query.shape[0], query.shape[1], key.shape[1])
    return flash_attention(query, key, value, kv_lens=kv_lens, scale=scale, rope_cos=cos, rope_sin=sin,
                           attn_mask=mask, causal=is_causal)


_FINDING_26_WARNED = []


def _kv_lens_from_padding_mask(attn_mask: torch.Tensor, skv: int) -> torch.Tensor:
    """Boolean (True = attend) or additive padding mask -> (B,) valid key
    counts (copied from `finetrainers_tpu/ops/attention.py:238-247`): masks are
    taken as prefix masks, each batch row attending to a prefix of the keys.
    A mask that depends on the query, such as a decoder tower's causal mask,
    becomes "every key a row of it sees is live" and loses that dependence, as
    in JAX (ROADMAP.md section 3, finding 26); one warning says so."""
    if not _FINDING_26_WARNED:
        _FINDING_26_WARNED.append(True)
        logger.warning("flash_varlen and sage read a dense mask as a padding mask (kv_lens = the keys any query "
                       "attends), as JAX does: a query-dependent mask such as a decoder's causal mask is lost "
                       "(ROADMAP.md section 3, finding 26)")
    mask = attn_mask if attn_mask.dtype == torch.bool else attn_mask > -1.0
    return mask.reshape(mask.shape[0], -1, skv).any(dim=1).sum(dim=-1, dtype=torch.int32)


@_AttentionProviderRegistry.register("flash_varlen")
def _flash_varlen(query, key, value, attn_mask, is_causal, scale, kv_lens, q_segment_ids=None, kv_segment_ids=None,
                  rope_freqs=None):
    """Packed variable-length batching (JAX `_flash_varlen`, :590-614): K4
    with segment ids (K1-K3's segment branches; with `is_causal` beside them
    it raises, as JAX does). A mask without kv_lens or segment ids is read as
    a padding mask and becomes kv_lens (finding 26). A mask beside either
    goes where JAX sends it, to XLA, which drops the segment ids: plain math
    on a CPU tensor, K1-K3's mask branches on a CUDA tensor."""
    if attn_mask is not None and kv_lens is None and kv_segment_ids is None:
        kv_lens = _kv_lens_from_padding_mask(attn_mask, key.shape[1])
        attn_mask = None
    if attn_mask is not None:
        if query.device.type == "cpu":
            return _math_rotated(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs)
        return _flex(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs)
    cos, sin = rope_freqs if rope_freqs is not None else (None, None)
    return flash_attention(query, key, value, kv_lens=kv_lens, scale=scale, rope_cos=cos, rope_sin=sin,
                           causal=is_causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)


def _sage(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs=None):
    """INT8 QK^T attention (`_sage`, JAX :574-588): every sage variant name maps
    to the pre-pass and K6, which rotate q and k with `rope_freqs`. A CUDA
    tensor goes to the kernels, which raise for what they do not take."""
    if attn_mask is not None and kv_lens is None:
        kv_lens = _kv_lens_from_padding_mask(attn_mask, key.shape[1])
        attn_mask = None
    if attn_mask is not None or is_causal:
        if query.device.type != "cpu":
            raise NotImplementedError(
                "K6 takes no causal or dense-mask call and the port never falls back to plain math on the card; "
                "see ROADMAP.md (K6)"
            )
        return _math_rotated(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs)
    cos, sin = rope_freqs if rope_freqs is not None else (None, None)
    return sage_attention(query, key, value, kv_lens=kv_lens, scale=scale, rope_cos=cos, rope_sin=sin)


for _name in _SAGE_NAMES:
    _AttentionProviderRegistry.register(_name)(_sage)


@_AttentionProviderRegistry.register("ring")
def _ring(query, key, value, attn_mask, is_causal, scale, kv_lens):
    """Ring attention on one card, where no context-parallel region exists: the
    JAX provider's branch outside one (`flash_attention`, JAX :620-622), so K4.
    Not a fused-RoPE provider: the dispatcher has rotated q and k already."""
    return _flash(query, key, value, attn_mask, is_causal, scale, kv_lens)


@_AttentionProviderRegistry.register("ulysses")
def _ulysses(query, key, value, attn_mask, is_causal, scale, kv_lens):
    """Ulysses on one card: the JAX provider's branch outside a
    context-parallel region (`_auto_attention`, JAX :679-680). q and k arrive
    rotated, as for `ring`."""
    return _auto_attention(query, key, value, attn_mask, is_causal, scale, kv_lens)


def _register_unported(name: str, roadmap_item: str) -> None:
    def _unported(query, key, value, attn_mask, is_causal, scale, kv_lens, rope_freqs=None):
        raise NotImplementedError(
            f"attention provider {name!r} is not ported to PyTorch yet; see ROADMAP.md: {roadmap_item}"
        )

    _AttentionProviderRegistry.register(name)(_unported)


for _name, _item in {
    "splash": "queue 1, attention dispatch (JAX alias providers)",
    "xla": "queue 1, attention dispatch (JAX alias providers)",
    "xformers": "queue 1, attention dispatch (JAX alias providers)",
    "_native_cudnn": "queue 1, attention dispatch (JAX alias providers)",
    "_native_efficient": "queue 1, attention dispatch (JAX alias providers)",
    "_native_flash": "queue 1, attention dispatch (JAX alias providers)",
}.items():
    _register_unported(_name, _item)
