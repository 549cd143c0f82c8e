"""Smoke run of the PyTorch port on one CUDA card: LTX-Video text-to-video serving,
the LTX-Video LoRA training step, Wan 2.1 T2V-1.3B serving under the int8
`sage` attention provider and the Wan 2.1 T2V-1.3B LoRA training step, with
every kernel switch of the flash attention.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
  2. the nvcc builds of the hand-written kernels, one process per source, all
     started together: K1 and K7a (`csrc/flash_fwd_sm90.cu`, wgmma and TMA),
     K2, K3 and K5 (`csrc/flash_bwd_sm90.cu`, wgmma and TMA, with K2's reduce
     pass for a split q loop, which K5 shares), K7b/c (`csrc/flash_fwd.cu`),
     K5's dq emit and the pre-pass that every forward but K7b and every
     backward runs first (`csrc/flash_bwd.cu`) and K6 with its pre-pass
     (`csrc/sage_fwd_sm90.cu`, int8 wgmma and TMA), timed, with ptxas'
     register, spill and warning lines; a spill in K5 or K7a fails the run;
  3. K1 against its plain PyTorch version (`flash_forward_core_reference` on
     the pre-pass's operands) and the pre-pass plus K1 (`flash_forward`)
     against `flash_attention_reference`, in bf16, at the LTX serving path's
     shapes (self-attention with per-head tables, cross-attention with
     kv_lens, a ragged case with an empty row whose k/v rows past kv_lens hold
     large values) and Wan's cross-attention shapes, with errors and median
     CUDA-event times of K1 alone and of the pre-pass;
  4. K2, K3 and the pre-pass against `flash_backward_reference` in bf16 at the
     training paths' shapes (LTX self-attention with per-head RoPE tables,
     cross-attention with kv_lens, a ragged case with an empty row, H=128 with
     shared tables, and Wan's training self-attention (1, 12, 19968, 128) with
     the shared Wan tables and cross-attention over 512 keys at full width,
     held one head at a time), with errors, CUDA-event and device times of K2
     and K3 and of their plain versions (`flash_bwd_dkdv_reference`,
     `flash_bwd_dq_reference`), bounds and the torch SDPA backward as a
     library yardstick;
  5. the sage pre-pass kernel (`sage_prep`: rotation with Wan's tables,
     smooth-K, int8 codes) against the plain pre-pass on the CPU, and K6 against
     `sage_attention_reference` on the same int8 codes and scales (Wan
     self-attention with the tables, Wan cross-attention over 512 text keys
     with kv_lens, LTX's self-attention shape, ragged cases with an empty row
     at H=128 and H=64); times of K6, the pre-pass, the plain pre-pass (torch's
     rotation and quantization on the card) and K6's plain version, the bounds
     and torch SDPA as a yardstick; then K1 at Wan's self-attention shape (H=128,
     one (S, H) table pair shared by every head) against its plain version,
     run head by head, timed alone and with its pre-pass;
  5b. K5 and its dq emit against K5's plain version and against K2+K3 (pre-pass
     included) at LTX's train self-attention with per-head tables, LTX's
     cross-attention, a ragged case with an empty row and Wan's training
     self-attention (1, 12, 19968, 128) with shared tables: errors, times of
     K5, the emit, K1, K2, K3 and both whole backwards, bounds, and the torch
     SDPA backward as the library yardstick; then K7a, K7b and K7c each
     against its plain version and against K1 at LTX's serving self-attention,
     Wan's self-attention (B=2, shared tables; K7b without tables), Wan's
     cross-attention (512 keys, kv_lens) and a ragged case with an empty row;
  6. LTX serving through the user entry points: the full-width LTX spec (random
     weights from a seeded generator, bf16) serves 2 prompts at 49x512x768 with
     CFG 3.0; checks the videos and that K1 and the pre-pass were each launched
     2*28*steps*requests times and no other kernel;
     then one denoise step with K1 against plain fp32 attention, seconds per step
     and per request, peak memory, and a torch.profiler breakdown of one step;
  7. Wan serving through the user entry points: the full-width Wan 2.1
     T2V-1.3B spec (random weights, bf16, 30 blocks) serves 2 prompts at
     49x512x768 with CFG 5.0 and 4 steps under `attention_provider("sage")`:
     checks the videos, that the sage pre-pass and K6 were each launched
     2*30*steps*requests times, K1 never, and that nothing rotated q or k in
     torch; one request under the default provider (K1 and the pre-pass,
     2*30*steps launches each); one denoise step with K6 against the same step
     with K1;
     seconds per step and per request, peak memory, and a torch.profiler
     breakdown of one sage step (K6 and its pre-pass, self and cross, GEMMs,
     the rest) and of one K1 step (K1 and its pre-pass, self and cross, GEMMs,
     the rest);
  8. training through the user entry points: `SFTTrainer` on the full-width spec
     with LoRA rank 128, one warm-up and 5 timed steps on seeded VAE moments
     (1, 256, 7, 16, 24) -> 2688 tokens and seeded caption states with a padded
     mask; checks finite losses, moved LoRA factors, unchanged frozen weights
     and 2*28 launches of K1, K2 and K3 and 4*28 of the pre-pass (forward and
     backward) per step; then one step's loss and LoRA
     gradient with the kernels against plain fp32 attention (both under per-block
     "full" remat), and a torch.profiler breakdown of one train step;
  9. Wan LoRA training through the user entry points: `SFTTrainer` on the
     full-width Wan 2.1 T2V-1.3B spec (rank 32, the optimizer of
     examples/training/sft/wan/crush_smol_lora/train.sh, logit-normal
     weighting, per-block "full" remat) on seeded VAE moments (1, 32, 13, 64,
     96) -> 19968 tokens and 512 valid caption tokens: one warm-up and 3 timed
     steps (finite losses, moved LoRA factors, unchanged frozen weights, K1
     4*30, the pre-pass 4*30 + 2*30, K2 and K3 2*30 launches per step, model
     TFLOP/s by
     tools/floor_bench.py's formula); the same step under
     FINETRAINERS_FLASH_FUSED_BWD (K5: bit-equal loss, LoRA gradient within
     1e-2, 2*30 K5 launches, its step time) and under each forward switch
     (K7a/b/c launch counts, loss within 1e-3 and gradient within 2e-2 of the
     K1 step), then 3 timed steps under FINETRAINERS_FLASH_TWOPASS (K7a);
     the kernel step against plain fp32 attention at 4992 tokens;
     host issue time and a torch.profiler breakdown of one step.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is not
0. Without a CUDA card it raises before printing any result.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models.ltx_video.transformer import LTXRotaryPosEmbed
from finetrainers_tpu_torch.models.wan.transformer import WanRotaryPosEmbed
from finetrainers_tpu_torch.ops import _build, attention_dispatch, attention_provider
from finetrainers_tpu_torch.ops import attention as attention_ops
from finetrainers_tpu_torch.ops.flash_attention import (
    _rope_bwd,
    dkdv_splits,
    flash_attention_reference,
    flash_backward,
    flash_backward_fused_reference,
    flash_backward_reference,
    flash_bwd_dkdv,
    flash_bwd_dkdv_reference,
    flash_bwd_dq,
    flash_bwd_dq_emit,
    flash_bwd_dq_reference,
    flash_bwd_fused,
    flash_forward,
    flash_forward_core,
    flash_forward_core_reference,
    flash_forward_skew,
    flash_forward_skew_reference,
    flash_forward_two_level,
    flash_forward_two_level_reference,
    flash_forward_twopass,
    flash_forward_twopass_reference,
    flash_qk_prep,
    flash_qk_prep_reference,
)
from finetrainers_tpu_torch.ops.sage_attention import sage_attention_reference, sage_forward, sage_prep, sage_quantize
from finetrainers_tpu_torch.trainer import SFTTrainer

NUM_STEPS = 8  # cut from the pipeline's default 50 to keep the run short
NUM_LAYERS = 28
BASE_PARAMS = 1_923_385_472  # the published LTX-Video transformer (jax.eval_shape on the JAX model)
PROMPTS = ("a red fox runs through fresh snow at dawn", "waves break on a rocky shore under a grey sky")
REQUEST = dict(num_frames=49, height=512, width=768, guidance_scale=3.0, num_inference_steps=NUM_STEPS)
# K1 (bf16 output) against the fp32 reference: |out - ref| <= K1_TOL * max(1, |ref|) elementwise,
# i.e. about two units in the last place of a bf16 value.
K1_TOL = 2e-2
LSE_TOL = 1e-2
# At Wan's 19968 keys a typical output value is ~1e-2, so the elementwise limit above is as large as
# the values: K1's Wan check also holds the relative L2 against the plain version to this limit.
K1_REL_L2_TOL = 1e-2
# K2/K3 (bf16 gradients) against the reference on the same bf16 inputs: the kernels' exp2 and fp32
# sums round a p or a ds to the neighbouring bf16 value now and then.
BWD_REL_L2_TOL = 1e-2
BWD_MAX_RATIO_TOL = 2e-2
STEP_REL_L2_TOL = 5e-2
TRAIN_LOSS_REL_TOL = 1e-2
# Training: LoRA rank and alpha as bench.py trains, B=1, the VAE moments of a 49x512x768 clip at
# the LTX VAE's 32x spatial / 8x temporal compression, 128 caption tokens of which 37 are valid.
TRAIN_RANK = 128
TRAIN_TIMED_STEPS = 5
MOMENTS_SHAPE = (1, 256, 7, 16, 24)
CAPTION_LEN, CAPTION_VALID = 128, 37
# Wan 2.1 T2V-1.3B serving: the repo's own Wan shape (tools/wan_attn_bench.py), 49x512x768 ->
# 13x64x96 latents -> 13x32x48 = 19968 tokens after the (1, 2, 2) patch; text padded to 512 tokens.
WAN_STEPS = 4  # cut from the pipeline's default 50 to keep the run short
WAN_LAYERS = 30
WAN_PARAMS = 1_418_996_800  # WAN_T2V_1_3B_CONFIG (jax.eval_shape on the JAX model)
WAN_REQUEST = dict(num_frames=49, height=512, width=768, guidance_scale=5.0, num_inference_steps=WAN_STEPS)
WAN_GRID = (13, 32, 48)
WAN_TOKENS = 19968
# K6 (bf16 output) against its plain version on the same codes: |out - ref| <= K6_TOL * max(1, |ref|)
# elementwise and relative L2 <= K6_REL_L2_TOL (the kernel rounds p to bf16 before P V).
K6_TOL = 2e-2
K6_REL_L2_TOL = 1e-2
# A denoise step with K6 against the same step with K1: int8 q/k against bf16, through 30 blocks.
K6_STEP_REL_L2_TOL = 0.1
# Wan 2.1 T2V-1.3B LoRA training (tools/floor_bench.py's setup_wan with the optimizer of
# examples/training/sft/wan/crush_smol_lora/train.sh): rank 32, B=1, the VAE moments of a 49x512x768 clip
# (13x64x96 latents -> 19968 tokens), 512 caption tokens, all valid; per-block "full" remat.
WAN_TRAIN_RANK = 32
WAN_TRAIN_TIMED_STEPS = 3
WAN_MOMENTS = (1, 32, 13, 64, 96)
WAN_SMALL_MOMENTS = (1, 32, 13, 32, 48)  # 4992 tokens: plain fp32 attention's scores fit under remat
WAN_CAPTION_LEN = 512
WAN_TRAIN_ARGS = dict(training_type="lora", rank=WAN_TRAIN_RANK, lora_alpha=WAN_TRAIN_RANK, seed=0, train_steps=3000,
                      flow_weighting_scheme="logit_normal", gradient_checkpointing=True,
                      gradient_checkpointing_type="full", optimizer="adamw", lr=5e-5,
                      lr_scheduler="constant_with_warmup", lr_warmup_steps=300, beta1=0.9, beta2=0.99,
                      weight_decay=1e-4, epsilon=1e-8, max_grad_norm=1.0)
# A step under a forward switch (K7a/b/c) against the step with K1: the same quantities with the softmax
# arithmetic reordered in fp32. Under the fused-backward switch (K5) the forward is K1's, so the loss is
# bit-equal; the LoRA gradient differs by K5's atomic fp32 sums of dq.
VARIANT_LOSS_REL_TOL = 1e-3
VARIANT_GRAD_REL_L2_TOL = 2e-2
FUSED_GRAD_REL_L2_TOL = 1e-2
SWITCHES = ("FINETRAINERS_FLASH_FUSED_BWD", "FINETRAINERS_FLASH_TWOPASS", "FINETRAINERS_FLASH_SKEW",
            "FINETRAINERS_FLASH_TWOLEVEL")
# The kernels whose ptxas record must show no spill: K5 and K7a (their consumers run at 240 and 160 registers).
NO_SPILL_KERNELS = ("bwd_fused_sm90_kernel", "flash_fwd_twopass_sm90_kernel")
# H100 SXM dense peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Median over `iters` launches of the CUDA-event time of one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernels, calls=5):
    """Device time of one call of `fn` from torch.profiler: over `calls` calls
    (after one warm-up), the durations of the kernels whose names contain one
    of `kernels`, summed and divided by the launches of the first (None if
    no trace holds one). Unlike `cuda_ms` it leaves out the host's time to
    issue them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the trace now and then comes back without the kernels' events: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA
                  and not getattr(evt, "is_user_annotation", False) and any(k in evt.name for k in kernels)]
        launches = sum(kernels[0] in evt.name for evt in events)
        if launches:
            return sum(evt.time_range.elapsed_us() for evt in events) / launches / 1e3
    return None


def bound(flops, nbytes):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rel_errors(got, ref):
    """(relative L2 error, max |error| / max |ref|, max |error|)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return ((got - ref).norm() / ref.norm()).item(), (err.max() / ref.abs().max()).item(), err.max().item()


def ltx_train_step_flops(cfg: dict, lora_rank: int, remat_factor: float, B: int, S: int, L_CTX: int) -> float:
    """Analytic matmul FLOPs for one LoRA train step on the LTX transformer
    (copied from bench.py's `ltx_train_step_flops`, with its shape constants as
    arguments). fwd counted exactly (matmul terms only); bwd for LoRA training
    needs dL/dx through every base matmul (~1x fwd) plus LoRA factor grads;
    remat recomputes `remat_factor` of the fwd."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    nl = cfg["num_layers"]
    cap = cfg["caption_channels"]
    cin = cfg["in_channels"]

    per_layer = 0.0
    per_layer += 4 * 2 * S * d * d            # attn1 q,k,v,out projections
    per_layer += 2 * 2 * S * S * d            # attn1 scores + weighted sum
    per_layer += 2 * 2 * S * d * d            # attn2 q,out
    per_layer += 2 * 2 * L_CTX * d * d        # attn2 k,v
    per_layer += 2 * 2 * S * L_CTX * d        # attn2 scores + out
    per_layer += 2 * 2 * S * d * 4 * d        # ff in + out
    per_layer += 6 * 2 * S * (d * lora_rank + lora_rank * d)

    fwd = nl * per_layer
    fwd += B * S * 2 * (256 * d + d * d + d * 6 * d)
    fwd += B * L_CTX * 2 * (cap * d + d * d)
    fwd += B * S * 2 * (cin * d + d * cin)

    fwd *= B
    return fwd * (2.0 + remat_factor)


# Kernel names of K2 (with its reduce pass) and K3, for `device_ms`.
K2_KERNELS = ("bwd_dkdv_sm90_kernel", "dkdv_reduce_kernel")
K3_KERNELS = ("bwd_dq_sm90_kernel",)
# Profile classes by kernel name; the pre-pass's class counts its forward and backward launches.
_KERNEL_CLASSES = (("k1", "flash_fwd_sm90_kernel"), ("k2", K2_KERNELS[0]), ("k2_reduce", K2_KERNELS[1]),
                   ("k3", K3_KERNELS[0]), ("prep", "rope_prep_kernel"), ("k6", "sage_fwd_sm90_kernel"),
                   ("sage_prep", "sage_prep_quant_kernel"), ("sage_prep_sum", "sage_prep_sum_kernel"),
                   ("sage_prep_mean", "sage_prep_mean_kernel"))
# The sage pre-pass's three kernels, one launch of `sage_prep` each.
SAGE_PREP_KERNELS = ("sage_prep_quant_kernel", "sage_prep_sum_kernel", "sage_prep_mean_kernel")


@contextlib.contextmanager
def counted(module, name):
    """Count the calls of `module.name` for the duration, in the yielded one-item list."""
    fn, calls = getattr(module, name), [0]

    def wrapper(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def profile_device(fn):
    """Device time of one call of `fn` by class from torch.profiler: the port's
    kernels (each launch kept in launch order), cuBLAS GEMMs, everything else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    classes, kernels, launches = {"gemm": 0.0, "other": 0.0}, {}, {cls: [] for cls, _ in _KERNEL_CLASSES}
    events = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
    for evt in events:
        if getattr(evt, "is_user_annotation", False):  # e.g. "Optimizer.step#AdamW.step", spanning other kernels
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        name = evt.name.lower()
        kernels[evt.name[:90]] = kernels.get(evt.name[:90], 0.0) + ms
        cls = next((c for c, pattern in _KERNEL_CLASSES if pattern in name), None)
        if cls is not None:
            launches[cls].append((evt.time_range.start, ms))
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
            classes["gemm"] += ms
        else:
            classes["other"] += ms
    launches = {cls: [ms for _, ms in sorted(v)] for cls, v in launches.items()}
    busy = sum(classes.values()) + sum(sum(v) for v in launches.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms if busy else None,
                classes=classes, launches=launches, top_kernels_ms=top, device_events=len(kernels))


def _split(ms_list, by_order):
    """Self- and cross-attention launches of one kernel: by launch order (each
    block runs self, then cross) or, where the order is autograd's, by size
    (self-attention over 2688 keys costs ~20x cross-attention over 128)."""
    if by_order:
        return ms_list[0::2], ms_list[1::2]
    ranked = sorted(ms_list, reverse=True)
    return ranked[:len(ranked) // 2], ranked[len(ranked) // 2:]


def _median(xs):
    return statistics.median(xs) if xs else None


def forward_classes(prof):
    """A forward step's device ms by class, with K1 and the pre-pass split into
    self- and cross-attention (every block runs self, then cross), and their
    launch counts and median ms per launch."""
    classes, per_launch = dict(prof["classes"]), {}
    for cls in ("k1", "prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=True)
        classes[f"{cls}_self_attention"], classes[f"{cls}_cross_attention"] = sum(self_ms), sum(cross_ms)
        per_launch[cls] = {"launches": [len(self_ms), len(cross_ms)], "self_attention": _median(self_ms),
                           "cross_attention": _median(cross_ms)}
    return classes, per_launch


def ltx_tables(n, h):
    rope = LTXRotaryPosEmbed(n * h)
    cos, sin = rope.numpy_tables(7, 16, 24, (8 / 25, 32.0, 32.0))
    return tuple(torch.from_numpy(t).cuda().reshape(2688, n, h).transpose(0, 1).contiguous() for t in (cos, sin))


def k1_bound(b, n, sq, kv_eff, h):
    """K1's least time on the pre-pass's operands: its two products against q_s,
    k_r and v read once (the valid keys), out and the LSE written once."""
    return bound(4 * n * sq * kv_eff * h, 2 * b * n * sq * h * 2 + 2 * n * kv_eff * h * 2 + b * n * sq * 4)


def bwd_bounds(b, n, sq, skv, kv_eff, h, cos):
    """K2's and K3's least times, (ms, "operations" or "bytes") each, on the
    pre-pass's operands: K2's four products against q_s, dO, LSE and delta
    read once, k_r and v of the valid keys read once, dk and dv written once
    and k's tables read; K3's three products against q_s, dO, LSE, delta and
    the valid keys read once, dq written once and q's tables read."""
    q_bytes, kv_eff_bytes, kv_bytes = b * n * sq * h * 2, n * kv_eff * h * 2, b * n * skv * h * 2
    row_bytes = b * n * sq * 4
    table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
    k2_bytes = 2 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + 2 * kv_bytes + table_bytes
    return (bound(8 * n * sq * kv_eff * h, k2_bytes),
            bound(6 * n * sq * kv_eff * h, 3 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + table_bytes))


def k5_bound(b, n, sq, skv, kv_eff, h, cos):
    """K5's least time: five products against q_s, dO, LSE and delta read once, k_r and v of the valid
    keys read once, k's tables read, dk, dv and the fp32 dq accumulator written once."""
    q_bytes, kv_eff_bytes, kv_bytes = b * n * sq * h * 2, n * kv_eff * h * 2, b * n * skv * h * 2
    table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
    return bound(10 * n * sq * kv_eff * h, 4 * q_bytes + 2 * kv_eff_bytes + 2 * b * n * sq * 4 + 2 * kv_bytes
                 + table_bytes)


def qk_prep_bound(q, k, cos):
    """The pre-pass's least time: q read and q_s written, and with tables k read,
    k_r written and the tables read."""
    q_bytes, k_bytes = q.numel() * 2, k.numel() * 2
    return bound(0, 2 * q_bytes + (2 * k_bytes + 2 * cos.numel() * 4 if cos is not None else 0))


def _fill_past_kv_lens(x, lens, value):
    """A copy of the BNSH `x` whose rows at or past lens[b] hold `value`."""
    y = x.clone()
    for bi, length in enumerate(lens):
        y[bi, :, length:] = value
    return y


def check_k1(card):
    """K1 against its plain version on the pre-pass's operands, and the pre-pass
    plus K1 (`flash_forward`) against `flash_attention_reference`, at the LTX
    serving path's shapes and Wan's cross-attention shapes (training B=1,
    serving B=2); in the ragged case the k/v rows past kv_lens are also filled
    with large values, which must leave out and LSE bit-equal (TMA reads those
    rows). Returns the worst error and the records by case."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cos_t, sin_t = ltx_tables(32, 64)
    cases = {
        "self_rope": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope=(cos_t, sin_t)),
        "cross_kv_lens": dict(b=2, n=32, sq=2688, skv=128, h=64, lens=[1, 12], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[50, 0], rope=None),
        "wan_train_cross_kv_lens": dict(b=1, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "wan_serve_cross_kv_lens": dict(b=2, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512, 9], rope=None),
    }
    worst, records = 0.0, {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        # BTNH buffers viewed as BNSH, the layout the model hands the kernel.
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for s in (sq, skv, skv))
        lens = None if c["lens"] is None else torch.tensor(c["lens"], dtype=torch.int32, device="cuda")
        cs, sn = c["rope"] or (None, None)
        rope_sn = 0 if cs is None or cs.shape[0] == 1 else sq * h
        scale = h**-0.5
        out, lse = flash_forward(q, k, v, lens, cs, sn)
        q_s, k_r = flash_qk_prep(q, k, cs, sn, rope_sn, scale)
        core_out, core_lse = flash_forward_core(q_s, k_r, v, lens)
        torch.cuda.synchronize()
        errs = {}
        for against, (got, got_lse), (ref, ref_lse) in (
                ("plain", (core_out, core_lse), flash_forward_core_reference(q_s, k_r, v, lens)),
                ("flash_attention_reference", (out, lse), flash_attention_reference(q, k, v, lens, cs, sn))):
            err = (got.float() - ref.float()).abs()
            errs[against] = dict(max_abs_err=err.max().item(),
                                 err_over_max1_ref=(err / ref.float().abs().clamp_min(1.0)).max().item(),
                                 lse_max_abs_err=(got_lse - ref_lse).abs().max().item())
        empty_zero = all(not out[i].any() for i, length in enumerate(c["lens"] or []) if length == 0)
        past_lens_ok = None
        if c["lens"] is not None and any(length < skv for length in c["lens"]):
            big = flash_forward_core(q_s, _fill_past_kv_lens(k_r, c["lens"], 3e4), _fill_past_kv_lens(v, c["lens"], -3e4),
                                     lens)
            zeroed = flash_forward_core(q_s, _fill_past_kv_lens(k_r, c["lens"], 0.0), _fill_past_kv_lens(v, c["lens"], 0.0),
                                        lens)
            past_lens_ok = torch.equal(big[0], zeroed[0]) and torch.equal(big[1], zeroed[1])
        ms = cuda_ms(lambda: flash_forward_core(q_s, k_r, v, lens))
        prep_ms = cuda_ms(lambda: flash_qk_prep(q, k, cs, sn, rope_sn, scale))
        forward_ms = cuda_ms(lambda: flash_forward(q, k, v, lens, cs, sn))
        plain_ms = cuda_ms(lambda: flash_forward_core_reference(q_s, k_r, v, lens), iters=5)
        # The "native" provider (torch SDPA), a library baseline without the fused rotation, for comparison only.
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: attention_dispatch(qt, kt, vt, kv_lens=lens, provider="native"))
        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        bound_ms, bound_by = k1_bound(b, n, sq, kv_eff, h)
        phase("k1_check", case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], vs_plain=errs["plain"],
              vs_flash_attention_reference=errs["flash_attention_reference"], empty_rows_zero=empty_zero,
              rows_past_kv_lens_ignored=past_lens_ok, ms=ms, prep_ms=prep_ms, flash_forward_ms=forward_ms,
              plain_ms=plain_ms, sdpa_baseline_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
              prep_bound_ms=qk_prep_bound(q, k, cs)[0], tflops=4 * n * sq * kv_eff * h / ms / 1e9, card=card)
        if not (all(e["err_over_max1_ref"] <= K1_TOL and e["lse_max_abs_err"] <= LSE_TOL for e in errs.values())
                and empty_zero and past_lens_ok is not False):
            raise AssertionError(f"K1 disagrees with its reference on {name}: {errs}, empty rows zero {empty_zero}, "
                                 f"rows past kv_lens ignored {past_lens_ok}")
        worst = max(worst, errs["plain"]["max_abs_err"], errs["flash_attention_reference"]["max_abs_err"])
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                             prep_ms=prep_ms, flash_forward_ms=forward_ms)
        del q, k, v, q_s, k_r, out, core_out
    return worst, records


def _by_head(fn, n, tensors, tables):
    """`fn(*tensors, *tables)` one head at a time, the results joined along the
    head dim: `tensors` are BNSH or (B, N, S) and are cut on dim 1, `tables`
    (N or 1, S, H) on dim 0 unless shared. The plain backward at Wan's shape
    would need ~80 GB of fp32 scores for all heads at once."""
    def table(t, i):
        return t if t is None or t.shape[0] == 1 else t[i:i + 1]

    outs = [fn(*(x[:, i:i + 1] for x in tensors), *(table(t, i) for t in tables)) for i in range(n)]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def check_k2k3(card):
    """The pre-pass, K2 and K3 against their plain versions at the training
    paths' shapes: LTX's self-attention with per-head tables, LTX's
    cross-attention with kv_lens, a ragged case with an empty row, H=128 with
    shared tables, and Wan's training self-attention (shared Wan tables) and
    cross-attention (kv_lens [512]) at full width, the Wan cases held against
    `flash_backward_reference` one head at a time. Returns the worst errors and
    the records by case."""
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {
        "self_rope": dict(b=1, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
        "cross_kv_lens": dict(b=1, n=32, sq=2688, skv=128, h=64, lens=[37], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
        "h128_shared_rope": dict(b=1, n=12, sq=4096, skv=4096, h=128, lens=None, rope="shared"),
        "wan_train_self_shared_rope": dict(b=1, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
        "wan_train_cross_kv_lens": dict(b=1, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512], rope=None),
    }
    worst = {"prep": 0.0, "k2": 0.0, "k3": 0.0}
    records = {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        q, k, v, do, lens, cos, sin = _bwd_case_inputs(c, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        by_head = sq * skv > 4096 * 4096
        out, lse = flash_forward(q, k, v, lens, cos, sin)
        delta = (do.float() * out.float()).sum(-1)

        grads = flash_backward(q, k, v, out, lse, do, lens, cos, sin)
        q_s, k_r = flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        torch.cuda.synchronize()
        if by_head:
            refs = _by_head(lambda *a: flash_backward_reference(*a[:6], lens, *a[6:]), n, (q, k, v, out, lse, do),
                            (cos, sin))
        else:
            refs = flash_backward_reference(q, k, v, out, lse, do, lens, cos, sin)
        ref_qs, ref_kr = flash_qk_prep_reference(q, k, cos, sin, scale)
        errors = {gname: rel_errors(got, ref) for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs)}
        errors["q_s"] = rel_errors(q_s, ref_qs)
        if cos is not None:
            errors["k_r"] = rel_errors(k_r, ref_kr)
        finite = all(bool(torch.isfinite(x).all()) for x in (*grads, q_s, k_r))
        del refs, ref_qs, ref_kr

        operands = (q_s, k_r, v, do, lse, delta, lens, cos, sin)

        def plain_k2():
            if by_head:
                return _by_head(lambda *a: flash_bwd_dkdv_reference(*a[:6], lens, *a[6:]), n, operands[:6], (cos, sin))
            return flash_bwd_dkdv_reference(*operands)

        def plain_k3():
            if by_head:
                return _by_head(lambda *a: (flash_bwd_dq_reference(*a[:6], lens, *a[6:], scale),), n,
                                operands[:6], (cos, sin))
            return flash_bwd_dq_reference(*operands, scale)

        plain_iters = 1 if by_head else 3
        prep_ms = cuda_ms(lambda: flash_qk_prep(q, k, cos, sin, rope_sn, scale))
        prep_plain_ms = cuda_ms(lambda: flash_qk_prep_reference(q, k, cos, sin, scale))
        k2_ms = cuda_ms(lambda: flash_bwd_dkdv(*operands, rope_sn))
        k3_ms = cuda_ms(lambda: flash_bwd_dq(*operands, rope_sn, scale))
        k2_device_ms = device_ms(lambda: flash_bwd_dkdv(*operands, rope_sn), K2_KERNELS)
        k3_device_ms = device_ms(lambda: flash_bwd_dq(*operands, rope_sn, scale), K3_KERNELS)
        backward_ms = cuda_ms(lambda: flash_backward(q, k, v, out, lse, do, lens, cos, sin))
        k2_plain_ms = cuda_ms(plain_k2, iters=plain_iters, warmup=plain_iters - 1)
        k3_plain_ms = cuda_ms(plain_k3, iters=plain_iters, warmup=plain_iters - 1)
        # torch SDPA's backward (dq, dk, dv in one call, no fused rotation): a library yardstick only.
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
        del sdpa_out, leaves

        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        k2_bound, k3_bound = bwd_bounds(b, n, sq, skv, kv_eff, h, cos)
        prep_bound = bound(0, 2 * b * n * sq * h * 2 + (2 * b * n * skv * h * 2 + 2 * cos.numel() * 4
                                                        if cos is not None else 0))
        splits = dkdv_splits(b, n, sq, skv, torch.cuda.get_device_properties(0).multi_processor_count)
        phase("k2k3_check", case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              plain_by_head=by_head, k2_splits=splits[0], rel_l2={k_: e[0] for k_, e in errors.items()},
              max_err_over_max_ref={k_: e[1] for k_, e in errors.items()},
              max_abs_err={k_: e[2] for k_, e in errors.items()}, finite=finite,
              prep_ms=prep_ms, prep_plain_ms=prep_plain_ms, k2_ms=k2_ms, k3_ms=k3_ms, k2_device_ms=k2_device_ms,
              k3_device_ms=k3_device_ms, flash_backward_ms=backward_ms, k2_plain_ms=k2_plain_ms,
              k3_plain_ms=k3_plain_ms, sdpa_backward_ms=sdpa_bwd_ms, k2_bound_ms=k2_bound[0], k3_bound_ms=k3_bound[0],
              k2_bound_by=k2_bound[1], k3_bound_by=k3_bound[1], prep_bound_ms=prep_bound[0],
              k2_tflops=8 * n * sq * kv_eff * h / k2_ms / 1e9, k3_tflops=6 * n * sq * kv_eff * h / k3_ms / 1e9,
              card=card)
        bad = [k_ for k_, e in errors.items() if not (e[0] <= BWD_REL_L2_TOL and e[1] <= BWD_MAX_RATIO_TOL)]
        if bad or not finite:
            raise AssertionError(f"the backward kernels disagree with their reference on {name}: {bad}, "
                                 f"finite={finite}")
        if c["lens"] is not None and 0 in c["lens"]:
            empty = c["lens"].index(0)
            if any(x[empty].any() for x in grads):
                raise AssertionError(f"{name}: a batch with no valid key got a nonzero gradient")
        worst["prep"] = max(worst["prep"], errors["q_s"][2], errors.get("k_r", (0, 0, 0))[2])
        worst["k2"] = max(worst["k2"], errors["dk"][2], errors["dv"][2])
        worst["k3"] = max(worst["k3"], errors["dq"][2])
        records[name] = dict(prep=(prep_ms, prep_plain_ms, None, *prep_bound),
                             k2=(k2_ms, k2_plain_ms, sdpa_bwd_ms, *k2_bound),
                             k3=(k3_ms, k3_plain_ms, sdpa_bwd_ms, *k3_bound),
                             k2_device_ms=k2_device_ms, k3_device_ms=k3_device_ms)
        del q, k, v, do, out, lse, delta, grads, q_s, k_r, operands
    return worst, records


def wan_tables():
    """Wan's expanded (S, 128) fp32 RoPE tables at the serving grid, as the model builds them."""
    return WanRotaryPosEmbed(128)(*WAN_GRID, torch.device("cuda"))


def k6_bound(n, sq, kv_eff, h, q_rows):
    """K6's least time: QK^T at the int8 peak plus P V at the bf16 peak, against
    the bytes of codes, scales, v and out read or written once."""
    ops_ms = (2 * n * sq * kv_eff * h / PEAK_INT8_OPS + 2 * n * sq * kv_eff * h / PEAK_BF16_FLOPS) * 1e3
    nbytes = q_rows * n * h * (1 + 2) + q_rows * n * 4 + n * kv_eff * (h + 4 + 2 * h)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_prepass(q, k, lens, codes, cos=None, sin=None):
    """The pre-pass kernel's codes and scales against the plain pre-pass on the
    CPU copy: q codes and scales equal, k codes within one and different in at
    most 0.1% of entries (the smoothed k's mean is summed in another order), k
    scales within rtol 1e-5. Returns (largest code difference, share of k codes
    that differ, max k scale relative error)."""
    cpu = sage_quantize(q.cpu(), k.cpu(), lens.cpu(), *(None if t is None else t.cpu() for t in (cos, sin)))
    if not (torch.equal(codes[0].cpu(), cpu[0]) and torch.equal(codes[2].cpu(), cpu[2])):
        raise AssertionError("the pre-pass's q codes or scales differ between the card and the CPU")
    diff = (codes[1].cpu().int() - cpu[1].int()).abs()
    share = (diff > 0).float().mean().item()
    scale_err = ((codes[3].cpu() - cpu[3]).abs() / cpu[3]).max().item()
    if diff.max() > 1 or share > 1e-3 or scale_err > 1e-5:
        raise AssertionError(f"the pre-pass's k codes differ: max {diff.max().item()}, share {share}, "
                             f"scale rel err {scale_err}")
    return diff.max().item(), share, scale_err


def prepass_bound(q, k, cos):
    """The pre-pass's least time (ms, "bytes"): q and k read, their int8 codes
    and fp32 per-token scales written, and the tables read, once each."""
    elems = q.numel() + k.numel()
    tokens = elems // q.shape[-1]
    table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
    return bound(0, elems * 2 + elems + tokens * 4 + table_bytes)


def check_k6(card):
    """The pre-pass kernel and K6 against their plain versions: the codes
    `sage_prep` writes on the card against `sage_quantize` on the CPU copy, and
    K6 against `sage_attention_reference` on the same codes and scales. Returns
    the worst K6 error, the worst code difference and the Wan self-attention
    case's records."""
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = {
        "wan_self_rope": dict(b=2, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope=True),
        "wan_cross_kv_lens": dict(b=2, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[1, 9], rope=False),
        "ltx_self": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope=False),
        "ragged_empty_row": dict(b=2, n=4, sq=1000, skv=77, h=128, lens=[77, 0], rope=False),
        "ragged_empty_row_h64": dict(b=2, n=4, sq=1000, skv=333, h=64, lens=[200, 0], rope=False),
    }
    worst, worst_code, records = 0.0, 0, {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        # BTNH, as the model hands them over; k with a per-channel offset, which smooth-K removes.
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16) for s in (sq, skv, skv))
        k = k + torch.randn(1, 1, n, h, generator=g, device="cuda").to(torch.bfloat16)
        cos, sin = (t[None].contiguous() for t in wan_tables()) if c["rope"] else (None, None)
        lens = torch.tensor(c["lens"] or [skv] * b, dtype=torch.int32, device="cuda")
        vt = v.transpose(1, 2)
        codes = sage_prep(q, k, lens, cos, sin)
        out = sage_forward(*codes, vt, lens)
        torch.cuda.synchronize()
        ref = sage_attention_reference(*codes, vt, lens)
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        norm_err = (err / ref.float().abs().clamp_min(1.0)).max().item()
        rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        empty_zero = all(not out[i].any() for i, length in enumerate(c["lens"] or []) if length == 0)
        code_diff, code_share, scale_err = check_prepass(q, k, lens, codes, cos, sin)
        ms = cuda_ms(lambda: sage_forward(*codes, vt, lens))
        prep_ms = cuda_ms(lambda: sage_prep(q, k, lens, cos, sin))
        # The plain pre-pass on the card: the torch rotation and quantization the parent ran before K6.
        prep_plain_ms = cuda_ms(lambda: sage_quantize(q, k, lens, cos, sin))
        plain_ms = cuda_ms(lambda: sage_attention_reference(*codes, vt, lens), iters=1, warmup=0)
        # torch SDPA on the bf16 inputs (no quantization, no rotation): a library yardstick only, never called
        # by the port.
        mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt, kt = q.transpose(1, 2), k.transpose(1, 2)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=None if c["lens"] is None
                                                                 else mask))
        kv_eff = int(lens.sum())
        bound_ms, bound_by = k6_bound(n, sq, kv_eff, h, b * sq)
        prep_bound_ms, _ = prepass_bound(q, k, cos)
        phase("k6_check", case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              max_abs_err=max_abs, err_over_max1_ref=norm_err, rel_l2=rel_l2, empty_rows_zero=empty_zero,
              prep_max_code_diff=code_diff, prep_k_codes_differing=code_share, prep_k_scale_rel_err=scale_err,
              ms=ms, plain_ms=plain_ms, sdpa_yardstick_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
              tops_equivalent=4 * n * sq * kv_eff * h / ms / 1e9, prep_ms=prep_ms, prep_plain_ms=prep_plain_ms,
              prep_bound_ms=prep_bound_ms, card=card)
        if not (norm_err <= K6_TOL and rel_l2 <= K6_REL_L2_TOL and empty_zero):
            raise AssertionError(f"K6 disagrees with its reference on {name}: {norm_err} > {K6_TOL}, "
                                 f"rel L2 {rel_l2} > {K6_REL_L2_TOL} or an empty row is not zero")
        worst, worst_code = max(worst, max_abs), max(worst_code, code_diff)
        records[name] = dict(k6=(ms, plain_ms, sdpa_ms, bound_ms, bound_by),
                             prep=(prep_ms, prep_plain_ms, None, prep_bound_ms, "bytes"))
        del q, k, v, vt, codes, out, ref, err
    return worst, worst_code, records


def check_k1_wan(card):
    """The pre-pass and K1 at Wan's self-attention shape (B=2, N=12, S=19968,
    H=128, one (S, H) table pair shared by every head) against their plain
    version, run one head at a time (all heads at once would need ~100 GB of
    fp32 scores); K1 is timed alone and with its pre-pass."""
    g = torch.Generator(device="cuda").manual_seed(8)
    b, n, s, h = 2, 12, WAN_TOKENS, 128
    q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    cos, sin = (t[None].contiguous() for t in wan_tables())
    out, lse = flash_forward(q, k, v, None, cos, sin)
    torch.cuda.synchronize()

    def plain():
        ref, ref_lse = torch.empty_like(out), torch.empty_like(lse)
        for bi in range(b):
            for ni in range(n):
                o, l_ = flash_attention_reference(q[bi:bi + 1, ni:ni + 1], k[bi:bi + 1, ni:ni + 1],
                                                  v[bi:bi + 1, ni:ni + 1], None, cos, sin)
                ref[bi, ni], ref_lse[bi, ni] = o[0, 0], l_[0, 0]
        return ref, ref_lse

    ref, ref_lse = plain()
    err = (out.float() - ref.float()).abs()
    max_abs = err.max().item()
    norm_err = (err / ref.float().abs().clamp_min(1.0)).max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    q_s, k_r = flash_qk_prep(q, k, cos, sin, 0, h**-0.5)
    ms = cuda_ms(lambda: flash_forward_core(q_s, k_r, v))
    prep_ms = cuda_ms(lambda: flash_qk_prep(q, k, cos, sin, 0, h**-0.5))
    forward_ms = cuda_ms(lambda: flash_forward(q, k, v, None, cos, sin))
    plain_ms = cuda_ms(plain, iters=1, warmup=0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: attention_dispatch(qt, kt, vt, provider="native"))
    flops = 4 * b * n * s * s * h
    bound_ms, bound_by = k1_bound(b, n, s, b * s, h)
    phase("k1_check", case="wan_self_rope_shared_tables", shape=[b, n, s, s, h], max_abs_err=max_abs,
          err_over_max1_ref=norm_err, rel_l2=rel_l2, lse_max_abs_err=lse_err, ms=ms, prep_ms=prep_ms,
          flash_forward_ms=forward_ms, plain_ms=plain_ms, sdpa_baseline_ms=sdpa_ms, bound_ms=bound_ms,
          bound_by=bound_by, prep_bound_ms=qk_prep_bound(q, k, cos)[0], tflops=flops / ms / 1e9, card=card)
    if not (norm_err <= K1_TOL and rel_l2 <= K1_REL_L2_TOL and lse_err <= LSE_TOL):
        raise AssertionError(f"K1 disagrees with its reference at Wan's shape: {norm_err}, rel L2 {rel_l2} "
                             f"or LSE {lse_err}")
    return max_abs, dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                         prep_ms=prep_ms, flash_forward_ms=forward_ms)


def _bwd_case_inputs(c, g):
    """q, k, v, dO (BNSH views of BTNH buffers), kv_lens and tables of a backward case."""
    b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
    q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
               for s in (sq, skv, skv))
    do = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
    lens = None if c["lens"] is None else torch.tensor(c["lens"], dtype=torch.int32, device="cuda")
    cos = sin = None
    if c["rope"] == "ltx":
        cos, sin = ltx_tables(n, h)
    elif c["rope"] == "wan":
        cos, sin = (t[None].contiguous() for t in wan_tables())
    elif c["rope"] == "shared":
        ang = torch.rand(1, sq, h // 2, generator=g, device="cuda") * 6.3
        cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
    return q, k, v, do, lens, cos, sin


def check_k5(card):
    """K5 and its dq emit (after the pre-pass) against K5's plain version and
    against K2+K3 at the training paths' shapes, including Wan's; returns the
    worst errors and the records of the Wan case (K5, emit, and K1 at Wan's
    training shape) and of LTX's self-attention."""
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = {
        "ltx_self_rope": dict(b=1, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
        "ltx_cross_kv_lens": dict(b=1, n=32, sq=2688, skv=128, h=64, lens=[37], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
        "wan_self_shared_rope": dict(b=1, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
    }
    worst = {"k5": 0.0, "k5_emit": 0.0}
    records = {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        q, k, v, do, lens, cos, sin = _bwd_case_inputs(c, g)
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        out, lse = flash_forward(q, k, v, lens, cos, sin)
        delta = (do.float() * out.float()).sum(-1)
        with switch("FINETRAINERS_FLASH_FUSED_BWD"):
            fused = flash_backward(q, k, v, out, lse, do, lens, cos, sin)
        split = flash_backward(q, k, v, out, lse, do, lens, cos, sin)
        q_s, k_r = flash_qk_prep(q, k, cos, sin, rope_sn, scale)
        dq_acc, _, _ = flash_bwd_fused(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn)
        emitted = flash_bwd_dq_emit(dq_acc, cos, sin, rope_sn, scale, q.dtype)
        torch.cuda.synchronize()
        refs = flash_backward_fused_reference(q, k, v, out, lse, do, lens, cos, sin)

        def emit_plain():
            dq = dq_acc * scale
            return (dq if cos is None else _rope_bwd(dq, cos, sin)).to(q.dtype)

        errors = {gname: rel_errors(got, ref) for gname, got, ref in zip(("dq", "dk", "dv"), fused, refs)}
        vs_split = {gname: rel_errors(got, ref) for gname, got, ref in zip(("dq", "dk", "dv"), fused, split)}
        emit_errors = rel_errors(emitted, emit_plain())
        finite = all(bool(torch.isfinite(x).all()) for x in fused)

        k5_ms = cuda_ms(lambda: flash_bwd_fused(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn))
        emit_ms = cuda_ms(lambda: flash_bwd_dq_emit(dq_acc, cos, sin, rope_sn, scale, q.dtype))
        emit_plain_ms = cuda_ms(emit_plain)
        with switch("FINETRAINERS_FLASH_FUSED_BWD"):
            fused_backward_ms = cuda_ms(lambda: flash_backward(q, k, v, out, lse, do, lens, cos, sin))
        split_backward_ms = cuda_ms(lambda: flash_backward(q, k, v, out, lse, do, lens, cos, sin))
        k2_ms = cuda_ms(lambda: flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn))
        k3_ms = cuda_ms(lambda: flash_bwd_dq(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn, scale))
        k1_ms = cuda_ms(lambda: flash_forward_core(q_s, k_r, v, lens))
        plain_ms = cuda_ms(lambda: flash_backward_fused_reference(q, k, v, out, lse, do, lens, cos, sin),
                           iters=1, warmup=0)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        del sdpa_out, leaves

        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        q_bytes, table_bytes = b * n * sq * h * 2, 2 * cos.numel() * 4 if cos is not None else 0
        k5_b = k5_bound(b, n, sq, skv, kv_eff, h, cos)
        emit_bound = bound(0, 2 * q_bytes + q_bytes + table_bytes)
        k2_bound, k3_bound = bwd_bounds(b, n, sq, skv, kv_eff, h, cos)
        k1_b = k1_bound(b, n, sq, kv_eff, h)
        phase("k5_check", case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              rel_l2={k_: e[0] for k_, e in errors.items()}, max_err_over_max_ref={k_: e[1] for k_, e in errors.items()},
              max_abs_err={k_: e[2] for k_, e in errors.items()},
              vs_k2k3_rel_l2={k_: e[0] for k_, e in vs_split.items()},
              vs_k2k3_max_err_over_max_ref={k_: e[1] for k_, e in vs_split.items()},
              emit_rel_l2=emit_errors[0], emit_max_abs_err=emit_errors[2], finite=finite, k5_ms=k5_ms, emit_ms=emit_ms, emit_plain_ms=emit_plain_ms,
              fused_backward_ms=fused_backward_ms, k2k3_backward_ms=split_backward_ms, k2_ms=k2_ms, k3_ms=k3_ms,
              k1_ms=k1_ms, plain_ms=plain_ms, sdpa_backward_ms=sdpa_bwd_ms, sdpa_forward_ms=sdpa_fwd_ms,
              k5_bound_ms=k5_b[0], emit_bound_ms=emit_bound[0], k2_bound_ms=k2_bound[0],
              k3_bound_ms=k3_bound[0], k1_bound_ms=k1_b[0],
              k5_tflops=10 * n * sq * kv_eff * h / k5_ms / 1e9, card=card)
        bad = [k_ for k_, e in {**errors, **{f"{k_}_vs_k2k3": e for k_, e in vs_split.items()},
                                 "emit": emit_errors}.items()
               if not (e[0] <= BWD_REL_L2_TOL and e[1] <= BWD_MAX_RATIO_TOL)]
        if bad or not finite:
            raise AssertionError(f"K5 disagrees on {name}: {bad}, finite={finite}")
        if c["lens"] is not None and 0 in c["lens"]:
            empty = c["lens"].index(0)
            if any(x[empty].any() for x in fused):
                raise AssertionError(f"{name}: a batch with no valid key got a nonzero gradient from K5")
        worst["k5"] = max(worst["k5"], *(e[2] for e in errors.values()))
        worst["k5_emit"] = max(worst["k5_emit"], emit_errors[2])
        records[name] = dict(
            k5=(k5_ms, plain_ms, sdpa_bwd_ms, *k5_b), k5_emit=(emit_ms, emit_plain_ms, None, *emit_bound),
            k1=(k1_ms, None, sdpa_fwd_ms, *k1_b), fused_backward_ms=fused_backward_ms)
        del q, k, v, do, out, lse, fused, split, q_s, k_r, dq_acc, emitted, refs
    return worst, records["wan_self_shared_rope"], records["ltx_self_rope"]


# name: (kernel, plain version). Each computes K1's function, so each bound counts K1's two products
# (QK^T, PV); K7a's second QK^T sweep is its own algorithm's cost and shows in its time against K1's.
K7_KERNELS = {
    "k7a": (flash_forward_twopass, flash_forward_twopass_reference),
    "k7b": (flash_forward_skew, flash_forward_skew_reference),
    "k7c": (flash_forward_two_level, flash_forward_two_level_reference),
}


def check_k7(card):
    """K7a, K7b and K7c against their plain versions and against K1, in bf16,
    at LTX's serving self-attention, Wan's self- and cross-attention at the
    training path's batch (1) and the serving batch (2), and a ragged case with
    an empty row (K7b takes no RoPE tables: its self-attention cases run
    without them, as does the K1 it is held against). Returns the worst errors
    and the records of each kernel at the shape the Wan training path gives it
    (self-attention; cross-attention for K7b)."""
    g = torch.Generator(device="cuda").manual_seed(10)
    cases = {
        "ltx_self_rope": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
        "wan_train_self_shared_rope": dict(b=1, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
        "wan_train_cross_kv_lens": dict(b=1, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512], rope=None),
        "wan_self_shared_rope": dict(b=2, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope="wan"),
        "wan_cross_kv_lens": dict(b=2, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[512, 9], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
    }
    worst = {name: 0.0 for name in K7_KERNELS}
    records = {name: {} for name in K7_KERNELS}
    for case, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        q, k, v, _, lens, case_cos, case_sin = _bwd_case_inputs(c, g)
        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        k1_runs = {}
        for name, (kernel, reference) in K7_KERNELS.items():
            cos, sin = (None, None) if name == "k7b" else (case_cos, case_sin)
            if (cos is None) not in k1_runs:  # K1 on the same call, and its time
                k1_runs[cos is None] = (*flash_forward(q, k, v, lens, cos, sin),
                                        cuda_ms(lambda: flash_forward(q, k, v, lens, cos, sin)))
            k1_out, k1_lse, k1_ms = k1_runs[cos is None]
            out, lse = kernel(q, k, v, lens, cos, sin)
            torch.cuda.synchronize()
            ref, ref_lse = reference(q, k, v, lens, cos, sin)
            errs = {}
            for against, (r_out, r_lse) in (("plain", (ref, ref_lse)), ("k1", (k1_out, k1_lse))):
                err = (out.float() - r_out.float()).abs()
                errs[against] = dict(max_abs_err=err.max().item(),
                                     err_over_max1_ref=(err / r_out.float().abs().clamp_min(1.0)).max().item(),
                                     rel_l2=((out.float() - r_out.float()).norm() / r_out.float().norm()).item(),
                                     lse_max_abs_err=(lse - r_lse).abs().max().item())
            empty_zero = all(not out[i].any() for i, length in enumerate(c["lens"] or []) if length == 0)
            ms = cuda_ms(lambda: kernel(q, k, v, lens, cos, sin))
            plain_ms = cuda_ms(lambda: reference(q, k, v, lens, cos, sin), iters=1, warmup=0)
            flops = 4 * n * sq * kv_eff * h
            table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
            bound_ms, bound_by = bound(flops, 2 * b * n * sq * h * 2 + 2 * n * kv_eff * h * 2 + b * n * sq * 4
                                       + table_bytes)
            phase("k7_check", kernel=name, case=case, shape=[b, n, sq, skv, h], kv_lens=c["lens"],
                  rope=None if cos is None else c["rope"], vs_plain=errs["plain"], vs_k1=errs["k1"],
                  empty_rows_zero=empty_zero, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, sdpa_forward_ms=sdpa_ms,
                  bound_ms=bound_ms,
                  bound_by=bound_by, tflops=flops / ms / 1e9, card=card)
            ok = all(e["err_over_max1_ref"] <= K1_TOL and e["lse_max_abs_err"] <= LSE_TOL
                     and e["rel_l2"] <= K1_REL_L2_TOL for e in errs.values())
            if not (ok and empty_zero):
                raise AssertionError(f"{name} disagrees on {case}: {errs}, empty rows zero: {empty_zero}")
            worst[name] = max(worst[name], errs["plain"]["max_abs_err"])
            records[name][case] = dict(ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
            del out, lse, ref, ref_lse
        del q, k, v, k1_runs
    main = {"k7a": "wan_train_self_shared_rope", "k7b": "wan_train_cross_kv_lens", "k7c": "wan_train_self_shared_rope"}
    return worst, {name: dict(records[name][main[name]], by_case=records[name]) for name in K7_KERNELS}


def serve(card):
    """The serving path; returns K1's launches there."""
    t0 = time.perf_counter()
    spec = get_model_specification_cls("ltx_video", "lora")(device=torch.device("cuda"), seed=0)
    pipe = spec.load_pipeline()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.transformer.module.parameters())
    phase("load", seconds=time.perf_counter() - t0, transformer_params=n_params,
          layers=len(pipe.transformer.module.transformer_blocks))
    if n_params != BASE_PARAMS or len(pipe.transformer.module.transformer_blocks) != NUM_LAYERS:
        raise AssertionError("the spec did not build the published LTX-Video width and depth")

    phase("serve_config", steps=NUM_STEPS, steps_note="cut from the default 50", **REQUEST)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    videos, request_s = [], []
    for seed, prompt in enumerate(PROMPTS):
        t0 = time.perf_counter()
        videos.append(pipe(prompt=prompt, seed=seed, **REQUEST))
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
    counts = _counts()
    launches = counts["k1"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = 2 * NUM_LAYERS * NUM_STEPS * len(PROMPTS)
    # LTX_VAE_CONFIG's decoder uses four of its five spatial flags, so a 49x512x768
    # request decodes to 49x256x384, as in the JAX package (ROADMAP.md).
    shape_ok = all(v.shape == (49, 256, 384, 3) and v.dtype == np.uint8 for v in videos)
    differ = not np.array_equal(videos[0], videos[1])
    phase("serve", requests=len(PROMPTS), video_shape=list(videos[0].shape), dtype=str(videos[0].dtype),
          videos_differ=differ, launches=counts, k1_and_prep_launches_expected=expected,
          request_seconds=request_s, peak_memory_gb=peak_gb, card=card)
    if not (shape_ok and differ and counts == {k_: expected if k_ in ("k1", "prep") else 0 for k_ in counts}):
        raise AssertionError("serving check failed")

    ehs, mask = pipe.encode_prompt(PROMPTS[0], None, True)
    latents = torch.randn(pipe.latent_shape(49, 512, 768), generator=torch.Generator("cuda").manual_seed(7),
                          device="cuda")
    sigma = float(pipe.scheduler.inference_sigmas(NUM_STEPS)[1])
    rope_scale = (1.0 / (25 / 8), 32.0, 32.0)
    with torch.inference_mode():
        step = lambda: pipe.denoise_step(latents, ehs, mask, 3.0, sigma, rope_scale)  # noqa: E731
        kernel_out = step()
        with attention_provider("_native_math"):
            plain_out = step()
            plain_step_ms = cuda_ms(step, iters=3, warmup=1)
        with attention_provider("native"):  # torch SDPA, the library baseline, for comparison only
            sdpa_out = step()
            sdpa_step_ms = cuda_ms(step, iters=5, warmup=1)
        step_ms = cuda_ms(step, iters=5, warmup=1)
        prof = profile_device(step)
    rel_l2 = ((kernel_out - plain_out).norm() / plain_out.norm()).item()
    sdpa_rel_l2 = ((sdpa_out - plain_out).norm() / plain_out.norm()).item()
    phase("step_vs_plain_attention", rel_l2=rel_l2, bound=STEP_REL_L2_TOL, sdpa_baseline_rel_l2=sdpa_rel_l2,
          finite=bool(torch.isfinite(kernel_out).all()))
    if not (rel_l2 <= STEP_REL_L2_TOL and torch.isfinite(kernel_out).all()):
        raise AssertionError(f"denoise step with K1 differs from plain attention: rel L2 {rel_l2}")

    phase("timing", card=card, denoise_step_s=step_ms / 1e3, denoise_step_plain_attention_s=plain_step_ms / 1e3,
          request_s=statistics.mean(request_s), requests_s=request_s, steps_per_request=NUM_STEPS,
          peak_memory_gb=peak_gb, denoise_step_sdpa_baseline_s=sdpa_step_ms / 1e3)
    classes, per_launch = forward_classes(prof)
    phase("profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, ms_per_launch=per_launch,
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return counts


def wan_serve(card):
    """The Wan serving path under `sage`, then under the default provider;
    returns the kernel launches of those runs."""
    t0 = time.perf_counter()
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0)
    pipe = spec.load_pipeline()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.transformer.module.parameters())
    phase("wan_load", seconds=time.perf_counter() - t0, transformer_params=n_params,
          layers=len(pipe.transformer.module.blocks))
    if n_params != WAN_PARAMS or len(pipe.transformer.module.blocks) != WAN_LAYERS:
        raise AssertionError("the spec did not build the published Wan 2.1 T2V-1.3B width and depth")

    def run(provider, prompts):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        videos, request_s = [], []
        with attention_provider(provider):
            for seed, prompt in enumerate(prompts):
                t0 = time.perf_counter()
                videos.append(pipe(prompt=prompt, seed=seed, **WAN_REQUEST))
                torch.cuda.synchronize()
                request_s.append(time.perf_counter() - t0)
        return videos, request_s, _counts(), torch.cuda.max_memory_allocated() / 1e9

    phase("wan_serve_config", steps=WAN_STEPS, steps_note="cut from the default 50", tokens=WAN_TOKENS,
          text_tokens=512, **WAN_REQUEST)
    with counted(attention_ops, "_rotate_interleaved_4d") as rotations:
        videos, request_s, launches, peak_gb = run("sage", PROMPTS)
    per_request = 2 * WAN_LAYERS * WAN_STEPS
    shape_ok = all(v.shape == (49, 512, 768, 3) and v.dtype == np.uint8 for v in videos)
    differ = not np.array_equal(videos[0], videos[1])
    # Every attention call launches the pre-pass, then K6; nothing rotates q or k in torch.
    phase("wan_serve", provider="sage", requests=len(PROMPTS), video_shape=list(videos[0].shape),
          dtype=str(videos[0].dtype), videos_differ=differ, launches=launches,
          k6_and_sage_prep_launches_expected=per_request * len(PROMPTS), torch_rotations=rotations[0],
          request_seconds=request_s, peak_memory_gb=peak_gb, card=card)
    if not (shape_ok and differ and rotations[0] == 0
            and launches == {k_: per_request * len(PROMPTS) if k_ in ("k6", "sage_prep") else 0
                             for k_ in launches}):
        raise AssertionError("Wan serving under sage failed its checks")
    sage_launches = launches
    del videos

    videos, auto_request_s, launches, auto_peak_gb = run("auto", PROMPTS[:1])
    phase("wan_serve", provider="auto", requests=1, video_shape=list(videos[0].shape), launches=launches,
          k1_launches_expected=per_request, request_seconds=auto_request_s, peak_memory_gb=auto_peak_gb, card=card)
    if not (videos[0].shape == (49, 512, 768, 3)
            and launches == {k_: per_request if k_ in ("k1", "prep") else 0 for k_ in launches}):
        raise AssertionError("Wan serving under the default provider failed its checks")
    auto_launches = launches
    del videos

    ehs, mask = pipe.encode_prompt(PROMPTS[0], None, True)
    latents = torch.randn(pipe.latent_shape(49, 512, 768), generator=torch.Generator("cuda").manual_seed(7),
                          device="cuda")
    sigma = float(pipe.scheduler.inference_sigmas(WAN_STEPS)[1])
    with torch.inference_mode():
        step = lambda: pipe.denoise_step(latents, ehs, mask, WAN_REQUEST["guidance_scale"], sigma)  # noqa: E731
        k1_out = step()
        k1_step_ms = cuda_ms(step, iters=3, warmup=1)
        k1_prof = profile_device(step)
        with attention_provider("sage"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k6_out = step()
            step_peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the transformer alone, without the decode
            k6_step_ms = cuda_ms(step, iters=3, warmup=1)
            with counted(attention_ops, "_rotate_interleaved_4d") as step_rotations:
                prof = profile_device(step)
    rel_l2 = ((k6_out - k1_out).norm() / k1_out.norm()).item()
    finite = bool(torch.isfinite(k6_out).all())
    phase("wan_step_k6_vs_k1", rel_l2=rel_l2, bound=K6_STEP_REL_L2_TOL, finite=finite,
          shape=list(k6_out.shape))
    if not (rel_l2 <= K6_STEP_REL_L2_TOL and finite):
        raise AssertionError(f"a denoise step with K6 differs from the one with K1: rel L2 {rel_l2}")
    phase("wan_timing", card=card, denoise_step_sage_s=k6_step_ms / 1e3, denoise_step_k1_s=k1_step_ms / 1e3,
          request_sage_s=statistics.mean(request_s), requests_sage_s=request_s, request_k1_s=auto_request_s[0],
          steps_per_request=WAN_STEPS, peak_memory_sage_gb=peak_gb, peak_memory_k1_gb=auto_peak_gb,
          peak_memory_sage_step_gb=step_peak_gb)
    # Every block runs the pre-pass and K6 twice, self-attention then cross-attention; the pre-pass is three
    # kernels, counted as one launch.
    k6_self, k6_cross = _split(prof["launches"]["k6"], by_order=True)
    prep = [sum(ms) for ms in zip(*(prof["launches"][cls] for cls in ("sage_prep_sum", "sage_prep_mean",
                                                                      "sage_prep")))]
    prep_self, prep_cross = _split(prep, by_order=True)
    classes = dict(prof["classes"], k6_self_attention=sum(k6_self), k6_cross_attention=sum(k6_cross),
                   sage_prep_self_attention=sum(prep_self), sage_prep_cross_attention=sum(prep_cross))
    phase("wan_profile", card=card, provider="sage", step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, k6_launches=[len(k6_self), len(k6_cross)],
          k6_ms_per_launch={"self_attention": _median(k6_self), "cross_attention": _median(k6_cross)},
          sage_prep_launches=[len(prep_self), len(prep_cross)],
          sage_prep_ms_per_launch={"self_attention": _median(prep_self), "cross_attention": _median(prep_cross)},
          torch_rotations=step_rotations[0], top_kernels_ms=prof["top_kernels_ms"],
          device_events=prof["device_events"])
    if step_rotations[0] or len(k6_self) + len(k6_cross) != 2 * WAN_LAYERS or len(prep) != 2 * WAN_LAYERS:
        raise AssertionError("a profiled sage step did not launch the pre-pass and K6 once per attention, or "
                             "rotated q or k in torch")
    classes, per_launch = forward_classes(k1_prof)
    phase("wan_profile", card=card, provider="auto", step_wall_ms=k1_prof["wall_ms"],
          device_busy_ms=k1_prof["busy_ms"], idle_share=k1_prof["idle_share"], ms_by_class=classes,
          ms_per_launch=per_launch, top_kernels_ms=k1_prof["top_kernels_ms"], device_events=k1_prof["device_events"])
    return sage_launches, auto_launches


_COUNTED = dict(k1=flash_forward, prep=flash_qk_prep, k2=flash_bwd_dkdv, k3=flash_bwd_dq, k5=flash_bwd_fused,
                k5_emit=flash_bwd_dq_emit, k6=sage_forward, sage_prep=sage_prep, k7a=flash_forward_twopass,
                k7b=flash_forward_skew, k7c=flash_forward_two_level)


def _counts():
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _zero_counts():
    for fn in _COUNTED.values():
        fn.launches = 0


@contextlib.contextmanager
def switch(name):
    """Set the kernel switch `name` to "1" for the duration (None: no switch)."""
    old = None if name is None else os.environ.get(name)
    if name is not None:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if name is not None:
            if old is None:
                del os.environ[name]
            else:
                os.environ[name] = old


def train_batch():
    """Seeded VAE moments of one 49x512x768 clip and seeded caption states with a padded mask."""
    g = torch.Generator("cuda").manual_seed(11)
    moments = torch.randn(MOMENTS_SHAPE, generator=g, device="cuda")
    moments[:, MOMENTS_SHAPE[1] // 2:] = 0.5 * moments[:, MOMENTS_SHAPE[1] // 2:] - 2.0  # log-variance
    channels = MOMENTS_SHAPE[1] // 2
    conditions = {
        "encoder_hidden_states": torch.randn(1, CAPTION_LEN, 4096, generator=g, device="cuda").to(torch.bfloat16),
        "encoder_attention_mask": (torch.arange(CAPTION_LEN, device="cuda") < CAPTION_VALID).to(torch.int32)[None],
    }
    latents = {"latents": moments, "latents_mean": torch.zeros(channels, device="cuda"),
               "latents_std": torch.ones(channels, device="cuda")}
    return conditions, latents


def train(card):
    """The training path; returns the kernels' launches there."""
    t0 = time.perf_counter()
    args = BaseArgs(training_type="lora", rank=TRAIN_RANK, lora_alpha=TRAIN_RANK, seed=0,
                    train_steps=1 + TRAIN_TIMED_STEPS)
    spec = get_model_specification_cls("ltx_video", "lora")(device=torch.device("cuda"), seed=0)
    trainer = SFTTrainer(args, spec)
    trainer.prepare()
    module = trainer.transformer.module
    torch.cuda.synchronize()
    frozen = [p for n, p in module.named_parameters() if n not in trainer._trainable]
    base_params = sum(p.numel() for p in frozen)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    phase("train_load", seconds=time.perf_counter() - t0, base_params=base_params, lora_params=lora_params,
          layers=len(module.transformer_blocks), rank=TRAIN_RANK, lora_alpha=TRAIN_RANK)
    if base_params != BASE_PARAMS or len(module.transformer_blocks) != NUM_LAYERS:
        raise AssertionError("the trainer did not build the published LTX-Video width and depth")

    def frozen_checksum():
        return torch.stack([torch.stack([p.float().sum(), p.float().abs().sum()]) for p in frozen]).double().sum(0)

    frozen_before = frozen_checksum()
    lora_before = {n: p.detach().clone() for n, p in trainer._trainable.items()}
    batch = train_batch()

    trainer.train([batch])  # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step_s = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        trainer.train([batch])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = trainer.state.train_state.global_avg_losses
    finite = all(np.isfinite(losses))
    moved = all(not torch.equal(p, lora_before[n]) for n, p in trainer._trainable.items())
    frozen_same = bool(torch.equal(frozen_checksum(), frozen_before))
    expected = 2 * NUM_LAYERS * TRAIN_TIMED_STEPS  # K1, K2, K3; the pre-pass runs before K1 and before K2/K3
    flops = ltx_train_step_flops(spec.transformer_config, TRAIN_RANK, 0.0, B=1, S=2688, L_CTX=CAPTION_LEN)
    median_s = statistics.median(step_s)
    phase("train", card=card, steps=trainer.state.train_state.step, timed_steps=TRAIN_TIMED_STEPS,
          step_seconds=step_s, median_step_s=median_s, losses=losses, losses_finite=finite,
          lora_factors_moved=moved, frozen_weights_unchanged=frozen_same, launches=launches,
          launches_expected_each=expected, prep_launches_expected=2 * expected, max_memory_allocated_gb=peak_gb,
          model_flops_per_step=flops,
          model_tflops=flops / median_s / 1e12, bf16_peak_tflops=PEAK_BF16_FLOPS / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS)
    if not (finite and moved and frozen_same
            and launches == {k_: {"k1": expected, "prep": 2 * expected, "k2": expected, "k3": expected}.get(k_, 0)
                             for k_ in launches}):
        raise AssertionError("training check failed")

    # One step's loss and LoRA gradient with the kernels against plain fp32
    # attention, both under per-block full remat (plain attention keeps fp32
    # (1, 32, 2688, 2688) scores per layer; remat frees them block by block).
    module.gradient_checkpointing = "full"

    def loss_and_grad(provider):
        trainer.optimizer.zero_grad()
        with attention_provider(provider):
            loss, _ = trainer.forward_backward(*batch, generator=torch.Generator("cuda").manual_seed(5))
        return loss.item(), torch.cat([p.grad.float().flatten() for p in trainer._trainable.values()])

    _zero_counts()
    kernel_loss, kernel_grad = loss_and_grad("auto")
    torch.cuda.synchronize()
    remat_launches = _counts()
    plain_loss, plain_grad = loss_and_grad("_native_math")
    trainer.optimizer.zero_grad()
    module.gradient_checkpointing = None
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    grad_rel_l2 = ((kernel_grad - plain_grad).norm() / plain_grad.norm()).item()
    grad_finite = bool(torch.isfinite(kernel_grad).all())
    del kernel_grad, plain_grad
    phase("train_step_vs_plain_attention", remat="full", kernel_loss=kernel_loss, plain_loss=plain_loss,
          loss_rel_diff=loss_rel, loss_bound=TRAIN_LOSS_REL_TOL, grad_rel_l2=grad_rel_l2,
          grad_bound=STEP_REL_L2_TOL, grad_finite=grad_finite, launches=remat_launches,
          k1_launches_expected=4 * NUM_LAYERS, k2_k3_launches_expected=2 * NUM_LAYERS,
          prep_launches_expected=6 * NUM_LAYERS)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel_l2 <= STEP_REL_L2_TOL and grad_finite
            and remat_launches["k1"] == 4 * NUM_LAYERS and remat_launches["prep"] == 6 * NUM_LAYERS
            and remat_launches["k2"] == remat_launches["k3"] == 2 * NUM_LAYERS):
        raise AssertionError("a train step with the kernels differs from the one with plain attention")

    # Where the host spends a step: issuing forward and backward, issuing the
    # update, then waiting for the card. A wait near 0 means the host bounds the step.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.optimizer.zero_grad()
    trainer.forward_backward(*batch)
    t1 = time.perf_counter()
    trainer.optimizer.step()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    host = dict(forward_backward_issue_s=t1 - t0, optimizer_issue_s=t2 - t1, wait_for_card_s=t3 - t2,
                step_s=t3 - t0)

    prof = profile_device(lambda: trainer.train_step(*batch))
    k1_self, k1_cross = _split(prof["launches"]["k1"], by_order=True)
    per_launch = {"k1": {"self_attention": _median(k1_self), "cross_attention": _median(k1_cross)}}
    for cls in ("k2", "k3", "prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=False)
        per_launch[cls] = {"self_attention": _median(self_ms), "cross_attention": _median(cross_ms)}
    per_launch["k2_reduce"] = {"cross_attention": _median(prof["launches"]["k2_reduce"])}  # split q loops only
    classes = dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()})
    phase("train_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, host_seconds=host,
          launches={cls: len(v) for cls, v in prof["launches"].items()}, ms_per_launch=per_launch,
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return launches


def wan_train_batch(moments_shape):
    """Seeded VAE moments of one clip (identity latent statistics, 16 channels)
    and seeded caption states with all 512 tokens valid."""
    g = torch.Generator("cuda").manual_seed(12)
    moments = torch.randn(moments_shape, generator=g, device="cuda")
    channels = moments_shape[1] // 2
    moments[:, channels:] = 0.5 * moments[:, channels:] - 2.0  # log-variance
    conditions = {
        "encoder_hidden_states": torch.randn(1, WAN_CAPTION_LEN, 4096, generator=g, device="cuda").to(torch.bfloat16),
        "encoder_attention_mask": torch.ones(1, WAN_CAPTION_LEN, dtype=torch.int32, device="cuda"),
    }
    latents = {"latents": moments, "latents_mean": torch.zeros(channels, device="cuda"),
               "latents_std": torch.ones(channels, device="cuda")}
    return conditions, latents


def wan_train_step_flops(cfg: dict, lora_rank: int, remat_factor: float, B: int, S: int, L_CTX: int) -> float:
    """Analytic matmul FLOPs of one Wan LoRA train step (copied from
    tools/floor_bench.py's `setup_wan` `flops`, with its shape constants as arguments)."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    fl = 4 * 2 * S * d * d
    fl += 2 * 2 * S * S * d  # self-attention scores+values
    fl += 2 * 2 * S * L_CTX * d  # cross-attention scores+values
    fl += 2 * 2 * L_CTX * d * d  # cross k/v projections
    fl += 2 * 2 * S * d * cfg["ffn_dim"]
    fl += 8 * 2 * S * (d * lora_rank + lora_rank * d)
    return cfg["num_layers"] * fl * B * (2.0 + remat_factor)


def wan_train(card):
    """The Wan 2.1 T2V-1.3B LoRA training path at full width: the timed steps
    (K1, pre-pass, K2, K3), the same step under the fused-backward switch (K5)
    and under each forward switch (K7a/b/c), a step against plain attention at
    4992 tokens and a profile. Returns the launches of each path."""
    t0 = time.perf_counter()
    spec = get_model_specification_cls("wan", "lora")(device=torch.device("cuda"), seed=0)
    trainer = SFTTrainer(BaseArgs(**WAN_TRAIN_ARGS), spec)
    trainer.prepare()
    module = trainer.transformer.module
    torch.cuda.synchronize()
    frozen = [p for n, p in module.named_parameters() if n not in trainer._trainable]
    base_params = sum(p.numel() for p in frozen)
    lora_params = sum(p.numel() for p in trainer._trainable.values())
    phase("wan_train_load", seconds=time.perf_counter() - t0, base_params=base_params, lora_params=lora_params,
          layers=len(module.blocks), remat=module.gradient_checkpointing,
          **{k_: v for k_, v in WAN_TRAIN_ARGS.items() if k_ not in ("training_type", "seed", "train_steps")})
    if (base_params != WAN_PARAMS or len(module.blocks) != WAN_LAYERS or module.gradient_checkpointing != "full"
            or trainer.scheduler.shift != 3.0):
        raise AssertionError("the trainer did not build the published Wan 2.1 T2V-1.3B width and depth under remat")

    def frozen_checksum():
        return torch.stack([torch.stack([p.float().sum(), p.float().abs().sum()]) for p in frozen]).double().sum(0)

    frozen_before = frozen_checksum()
    lora_before = {n: p.detach().clone() for n, p in trainer._trainable.items()}
    batch = wan_train_batch(WAN_MOMENTS)

    def timed_steps(count):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        seconds = []
        for _ in range(count):
            t0 = time.perf_counter()
            trainer.train([batch])
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return seconds, _counts(), torch.cuda.max_memory_allocated() / 1e9

    trainer.train([batch])  # warm-up step
    step_s, launches, peak_gb = timed_steps(WAN_TRAIN_TIMED_STEPS)
    losses = trainer.state.train_state.global_avg_losses
    finite = all(np.isfinite(losses))
    moved = all(not torch.equal(p, lora_before[n]) for n, p in trainer._trainable.items())
    frozen_same = bool(torch.equal(frozen_checksum(), frozen_before))
    del lora_before
    # The pre-pass runs before each of K1's 4*30 launches (forward and recompute) and each of the 2*30 backwards.
    per_step = dict(k1=4 * WAN_LAYERS, prep=6 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)
    expected = {k_: per_step.get(k_, 0) * WAN_TRAIN_TIMED_STEPS for k_ in launches}
    flops = wan_train_step_flops(spec.transformer_config, WAN_TRAIN_RANK, 1.0, B=1, S=WAN_TOKENS,
                                 L_CTX=WAN_CAPTION_LEN)
    median_s = statistics.median(step_s)
    phase("wan_train", card=card, steps=trainer.state.train_state.step, timed_steps=WAN_TRAIN_TIMED_STEPS,
          tokens=WAN_TOKENS, text_tokens=WAN_CAPTION_LEN, step_seconds=step_s, median_step_s=median_s, losses=losses,
          losses_finite=finite, lora_factors_moved=moved, frozen_weights_unchanged=frozen_same, launches=launches,
          launches_expected=expected, max_memory_allocated_gb=peak_gb, model_flops_per_step=flops,
          model_tflops=flops / median_s / 1e12, bf16_peak_tflops=PEAK_BF16_FLOPS / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS)
    if not (finite and moved and frozen_same and launches == expected):
        raise AssertionError("Wan training check failed")
    paths = {"wan_train": launches}

    def loss_and_grad(env, step_batch=batch, provider="auto"):
        trainer.optimizer.zero_grad()
        _zero_counts()
        with switch(env), attention_provider(provider):
            loss, _ = trainer.forward_backward(*step_batch, generator=torch.Generator("cuda").manual_seed(5))
        grad = torch.cat([p.grad.float().flatten() for p in trainer._trainable.values()])
        torch.cuda.synchronize()
        return loss.item(), grad, _counts()

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    # K5: the same step under the fused-backward switch.
    split_loss, split_grad, split_launches = loss_and_grad(None)
    fused_loss, fused_grad, fused_launches = loss_and_grad("FINETRAINERS_FLASH_FUSED_BWD")
    fused_rel = rel_l2(fused_grad, split_grad)
    del fused_grad

    # K7a/b/c: one forward_backward under each forward switch, against the K1 step above, at the
    # same weights (before the fused-backward timed steps update them). K7a and K7c run the pre-pass
    # first, as K1 does; K7b (cross-attention only: the self-attention calls carry tables and stay on
    # K1) does not.
    for env, key, expected_k1, count in (("FINETRAINERS_FLASH_TWOPASS", "k7a", 0, 4 * WAN_LAYERS),
                                          ("FINETRAINERS_FLASH_SKEW", "k7b", 2 * WAN_LAYERS, 2 * WAN_LAYERS),
                                          ("FINETRAINERS_FLASH_TWOLEVEL", "k7c", 0, 4 * WAN_LAYERS)):
        loss, grad, variant_launches = loss_and_grad(env)
        loss_rel, grad_rel = abs(loss - split_loss) / abs(split_loss), rel_l2(grad, split_grad)
        del grad
        forwards_with_prep = 4 * WAN_LAYERS if key != "k7b" else expected_k1
        want = dict(k1=expected_k1, prep=forwards_with_prep + 2 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS,
                    **{key: count})
        want = {k_: want.get(k_, 0) for k_ in variant_launches}
        phase("wan_train_fwd_variants", card=card, switch=env, kernel=key, loss=loss, k1_loss=split_loss,
              loss_rel_diff=loss_rel, loss_bound=VARIANT_LOSS_REL_TOL, lora_grad_rel_l2=grad_rel,
              grad_bound=VARIANT_GRAD_REL_L2_TOL, launches=variant_launches, launches_expected=want)
        if not (loss_rel <= VARIANT_LOSS_REL_TOL and grad_rel <= VARIANT_GRAD_REL_L2_TOL and variant_launches == want):
            raise AssertionError(f"the Wan step under {env} failed its checks")
        paths[f"wan_train_{key}"] = variant_launches
    del split_grad

    with switch("FINETRAINERS_FLASH_FUSED_BWD"):
        fused_step_s, fused_timed_launches, fused_peak_gb = timed_steps(WAN_TRAIN_TIMED_STEPS)
    fused_expected = dict(k1=4 * WAN_LAYERS, prep=6 * WAN_LAYERS, k5=2 * WAN_LAYERS, k5_emit=2 * WAN_LAYERS)
    fused_expected = {k_: fused_expected.get(k_, 0) for k_ in fused_launches}
    phase("wan_train_fused_bwd", card=card, split_loss=split_loss, fused_loss=fused_loss,
          loss_bit_equal=fused_loss == split_loss, lora_grad_rel_l2=fused_rel, grad_bound=FUSED_GRAD_REL_L2_TOL,
          launches=fused_launches, launches_expected=fused_expected, split_launches=split_launches,
          step_seconds=fused_step_s, median_step_s=statistics.median(fused_step_s),
          split_median_step_s=median_s, max_memory_allocated_gb=fused_peak_gb)
    if not (fused_loss == split_loss and fused_rel <= FUSED_GRAD_REL_L2_TOL and fused_launches == fused_expected
            and all(v == fused_expected[k_] * WAN_TRAIN_TIMED_STEPS for k_, v in fused_timed_launches.items())):
        raise AssertionError("the Wan step under the fused-backward switch failed its checks")
    paths["wan_train_fused_bwd"] = fused_launches

    # K7a: timed steps under the two-pass switch, beside the fused-backward ones above.
    with switch("FINETRAINERS_FLASH_TWOPASS"):
        twopass_step_s, twopass_launches, twopass_peak_gb = timed_steps(WAN_TRAIN_TIMED_STEPS)
    twopass_expected = dict(k7a=4 * WAN_LAYERS, prep=6 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)
    twopass_expected = {k_: twopass_expected.get(k_, 0) * WAN_TRAIN_TIMED_STEPS for k_ in twopass_launches}
    phase("wan_train_fwd_variants", card=card, switch="FINETRAINERS_FLASH_TWOPASS", kernel="k7a", timed=True,
          step_seconds=twopass_step_s, median_step_s=statistics.median(twopass_step_s), split_median_step_s=median_s,
          fused_bwd_median_step_s=statistics.median(fused_step_s), launches=twopass_launches,
          launches_expected=twopass_expected, max_memory_allocated_gb=twopass_peak_gb)
    if twopass_launches != twopass_expected:
        raise AssertionError("the timed Wan steps under the two-pass switch launched other kernels")

    # The kernel step against plain fp32 attention at 4992 tokens (plain scores are 1.2 GB per layer).
    small = wan_train_batch(WAN_SMALL_MOMENTS)
    kernel_loss, kernel_grad, small_launches = loss_and_grad(None, small)
    plain_loss, plain_grad, _ = loss_and_grad(None, small, provider="_native_math")
    trainer.optimizer.zero_grad()
    loss_rel, grad_rel = abs(kernel_loss - plain_loss) / abs(plain_loss), rel_l2(kernel_grad, plain_grad)
    grad_finite = bool(torch.isfinite(kernel_grad).all())
    del kernel_grad, plain_grad, small
    phase("wan_train_step_vs_plain_attention", remat="full", tokens=13 * 16 * 24, kernel_loss=kernel_loss,
          plain_loss=plain_loss, loss_rel_diff=loss_rel, loss_bound=TRAIN_LOSS_REL_TOL, grad_rel_l2=grad_rel,
          grad_bound=STEP_REL_L2_TOL, grad_finite=grad_finite, launches=small_launches)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= STEP_REL_L2_TOL and grad_finite
            and small_launches == {k_: per_step.get(k_, 0) for k_ in small_launches}):
        raise AssertionError("a Wan train step with the kernels differs from the one with plain attention")

    # Where the host spends a step: issuing forward and backward, issuing the update, waiting for the card.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.optimizer.zero_grad()
    trainer.forward_backward(*batch)
    t1 = time.perf_counter()
    trainer.optimizer.step()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    host = dict(forward_backward_issue_s=t1 - t0, optimizer_issue_s=t2 - t1, wait_for_card_s=t3 - t2, step_s=t3 - t0)

    prof = profile_device(lambda: trainer.train_step(*batch))
    per_launch = {}
    for cls in ("k1", "k2", "k3", "prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=False)
        per_launch[cls] = {"self_attention": _median(self_ms), "cross_attention": _median(cross_ms)}
    per_launch["k2_reduce"] = {"cross_attention": _median(prof["launches"]["k2_reduce"])}  # split q loops only
    classes = dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()})
    phase("wan_train_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, host_seconds=host,
          launches={cls: len(v) for cls, v in prof["launches"].items()}, ms_per_launch=per_launch,
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return paths


def _kernel_name(mangled):
    """`name<args>` of a mangled kernel, namespaces dropped, e.g.
    `flash_fwd_sm90_kernel<__nv_bfloat16, 128>`; else the mangled name."""
    rest, name, args = mangled[3:] if mangled.startswith("_ZN") else "", None, []
    while m := re.match(r"(\d+)", rest):  # the nested names, each <length><name>; the last is the kernel's
        end = m.end() + int(m.group(1))
        name, rest = rest[m.end():end], rest[end:]
    if name is None:
        return mangled
    if rest.startswith("I"):
        rest = rest[1:]
        while m := re.match(r"L[a-z](\d+)E|(\d+)", rest):
            if m.group(1) is not None:
                args.append(m.group(1))
                rest = rest[m.end():]
            else:
                end = m.end() + int(m.group(2))
                args.append(rest[m.end():end])
                rest = rest[end:]
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_summary(log):
    """Registers and spill bytes of each kernel from nvcc's `-Xptxas=-v` log,
    and its warning lines."""
    kernels, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = _kernel_name(m.group(1))
            kernels[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(m.group(1))
    return {"ptxas": kernels, "warnings": [line.strip() for line in log.splitlines() if "warning" in line.lower()]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    sources = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_fwd", "flash_bwd", "sage_fwd_sm90")
    _build.load_libraries(sources)
    builds = {name: {"seconds": _build.BUILD_LOG[name]["seconds"], **ptxas_summary(_build.BUILD_LOG[name]["log"])}
              for name in sources}
    phase("build", seconds=time.perf_counter() - t0, kernels=builds)
    spilled = {name: rec for src in builds.values() for name, rec in src["ptxas"].items()
               if name.startswith(NO_SPILL_KERNELS) and (rec.get("spill_stores") or rec.get("spill_loads"))}
    if spilled:
        raise AssertionError(f"K5 or K7a spills registers: {spilled}")

    k1_err, k1 = check_k1(card)
    bwd_err, bwd = check_k2k3(card)
    k6_err, prep_err, k6 = check_k6(card)
    k1_wan_err, k1_wan = check_k1_wan(card)
    k5_err, k5_wan, k5_ltx = check_k5(card)
    k7_err, k7 = check_k7(card)
    torch.cuda.empty_cache()
    serve_launches = serve(card)
    torch.cuda.empty_cache()
    wan_sage_launches, wan_auto_launches = wan_serve(card)
    torch.cuda.empty_cache()
    train_launches = train(card)
    torch.cuda.empty_cache()
    wan_paths = wan_train(card)

    def entry(name, source, replaces, launches, err, record, **extra):
        ms, plain_ms, library_ms, bound_ms, bound_by = record
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, **extra)

    def wan_shape(record):  # a K1 record of check_k5 at Wan's training shape (no plain version timed there)
        ms, _, library_ms, bound_ms, bound_by = record
        return dict(shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128], ms=ms, library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by)

    def ptxas(source, kernel):  # the registers and spill bytes of `kernel`'s instantiations
        return {name: rec for name, rec in builds[source]["ptxas"].items() if name.startswith(kernel + "<")}

    def k7_entry(key, name, replaces, source="flash_fwd", **extra):
        r = k7[key]
        return entry(name, f"finetrainers_tpu_torch/csrc/{source}.cu", replaces, wan_paths[f"wan_train_{key}"][key],
                     k7_err[key], (r["ms"], r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"]),
                     launches_by_path={f"wan_train_{key}": wan_paths[f"wan_train_{key}"][key]},
                     by_case=r["by_case"], library_note="torch SDPA forward, without the fused rotation", **extra)

    def bwd_entry(key, name, replaces):  # K2 or K3: the Wan training self-attention case, the others by case
        fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        return entry(name, "finetrainers_tpu_torch/csrc/flash_bwd_sm90.cu", replaces, wan[key], bwd_err[key],
                     bwd["wan_train_self_shared_rope"][key],
                     launches_by_path={"train": train_launches[key], "wan_train": wan[key]},
                     shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128],
                     device_ms=bwd["wan_train_self_shared_rope"][f"{key}_device_ms"],
                     by_case={case: dict(zip(fields, r[key]), device_ms=r[f"{key}_device_ms"])
                              for case, r in bwd.items()},
                     library_note="torch SDPA backward (dq, dk, dv in one call), without the fused rotation")

    wan = wan_paths["wan_train"]
    ltx_self = k1["self_rope"]
    print(json.dumps({"kernels": [
        entry("flash_fwd_sm90 (K1, wgmma + TMA, on the pre-pass's operands)",
              "finetrainers_tpu_torch/csrc/flash_fwd_sm90.cu", "finetrainers_tpu/ops/flash_attention.py:106",
              serve_launches["k1"], max(k1_err, k1_wan_err),
              (ltx_self["ms"], ltx_self["plain_ms"], ltx_self["library_ms"], ltx_self["bound_ms"],
               ltx_self["bound_by"]),
              launches_by_path={"serve": serve_launches["k1"], "train": train_launches["k1"],
                                "wan_serve_default_provider": wan_auto_launches["k1"], "wan_train": wan["k1"],
                                **{f"wan_train_{key}": wan_paths[f"wan_train_{key}"]["k1"]
                                   for key in ("k7a", "k7b", "k7c", "fused_bwd")}},
              shape=[2, 32, 2688, 2688, 64], by_case=k1, wan_self_attention=k1_wan,
              wan_train_self_attention=wan_shape(k5_wan["k1"]),
              library_note="torch SDPA forward, without the fused rotation"),
        entry("flash_qk_prep (the RoPE and q-scale pre-pass before K1, K7a, K7c, K2/K3 and K5)",
              "finetrainers_tpu_torch/csrc/flash_bwd.cu", "finetrainers_tpu/ops/flash_attention.py:189",
              serve_launches["prep"], bwd_err["prep"], bwd["self_rope"]["prep"],
              also_replaces=["finetrainers_tpu/ops/flash_attention.py:961",
                             "finetrainers_tpu/ops/flash_attention.py:1268"],
              launches_by_path={"serve": serve_launches["prep"], "train": train_launches["prep"],
                                "wan_serve_default_provider": wan_auto_launches["prep"], "wan_train": wan["prep"],
                                **{f"wan_train_{key}": wan_paths[f"wan_train_{key}"]["prep"]
                                   for key in ("k7a", "k7b", "k7c", "fused_bwd")}},
              shape_note="timed at LTX's train self-attention (1, 32, 2688, 64) with per-head tables"),
        bwd_entry("k2", "bwd_dkdv_sm90 (K2, wgmma + TMA, with its reduce pass where the q loop is split)",
                  "finetrainers_tpu/ops/flash_attention.py:888"),
        bwd_entry("k3", "bwd_dq_sm90 (K3, wgmma + TMA)", "finetrainers_tpu/ops/flash_attention.py:1199"),
        entry("bwd_fused_sm90 (K5, wgmma + TMA, dq added by TMA reduces)",
              "finetrainers_tpu_torch/csrc/flash_bwd_sm90.cu",
              "finetrainers_tpu/ops/flash_attention.py:1038", wan_paths["wan_train_fused_bwd"]["k5"], k5_err["k5"],
              k5_wan["k5"], launches_by_path={"wan_train_fused_bwd": wan_paths["wan_train_fused_bwd"]["k5"]},
              shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128], fused_backward_ms=k5_wan["fused_backward_ms"],
              ptxas=ptxas("flash_bwd_sm90", "bwd_fused_sm90_kernel"),
              ltx_train_self_attention=dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                                k5_ltx["k5"])),
              library_note="torch SDPA backward (dq, dk, dv), without the fused rotation"),
        entry("bwd_fused dq emit (K5's scale, transpose rotation and cast of dq)",
              "finetrainers_tpu_torch/csrc/flash_bwd.cu", "finetrainers_tpu/ops/flash_attention.py:1191",
              wan_paths["wan_train_fused_bwd"]["k5_emit"], k5_err["k5_emit"], k5_wan["k5_emit"],
              launches_by_path={"wan_train_fused_bwd": wan_paths["wan_train_fused_bwd"]["k5_emit"]}),
        k7_entry("k7a", "flash_fwd_twopass_sm90 (K7a, wgmma + TMA, on the pre-pass's operands)",
                 "finetrainers_tpu/ops/flash_attention.py:337", source="flash_fwd_sm90",
                 ptxas=ptxas("flash_fwd_sm90", "flash_fwd_twopass_sm90_kernel")),
        k7_entry("k7b", "fwd_skew (K7b)", "finetrainers_tpu/ops/flash_attention.py:491"),
        k7_entry("k7c", "fwd two-level (K7c)", "finetrainers_tpu/ops/flash_attention.py:229"),
        entry("sage_fwd_sm90 (K6, int8 wgmma + TMA, on the pre-pass's codes)",
              "finetrainers_tpu_torch/csrc/sage_fwd_sm90.cu", "finetrainers_tpu/ops/sage_attention.py:36",
              wan_sage_launches["k6"], k6_err, k6["wan_self_rope"]["k6"], shape=[2, 12, WAN_TOKENS, WAN_TOKENS, 128],
              by_case={case: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), r["k6"]))
                       for case, r in k6.items()},
              library_note="torch SDPA on the unquantized, unrotated bf16 inputs: a yardstick only"),
        entry("sage_prep (rotation, smooth-K and int8 quantization of q and k before K6)",
              "finetrainers_tpu_torch/csrc/sage_fwd_sm90.cu", "finetrainers_tpu/ops/sage_attention.py:112",
              wan_sage_launches["sage_prep"], prep_err, k6["wan_self_rope"]["prep"],
              also_replaces=["finetrainers_tpu/ops/attention.py:121"], shape=[2, 12, WAN_TOKENS, WAN_TOKENS, 128],
              by_case={case: dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), r["prep"]))
                       for case, r in k6.items()},
              max_abs_err_note="the largest difference of an int8 code from the plain pre-pass on the CPU",
              plain_note="the plain pre-pass on the card: torch's rotation and quantization, the path before it"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
