"""Smoke run of the PyTorch port on one CUDA card: LTX-Video text-to-video serving,
the LTX-Video LoRA training step, Wan 2.1 T2V-1.3B serving under the int8
`sage` attention provider and the Wan 2.1 T2V-1.3B LoRA training step, with
every kernel switch of the flash attention.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
  2. the nvcc builds of the hand-written kernels, one process per source, all
     started together: K1 and K7a/b/c (`csrc/flash_fwd.cu`), K2, K3, K5, K5's
     dq emit and their pre-pass (`csrc/flash_bwd.cu`) and K6
     (`csrc/sage_fwd.cu`), timed, with ptxas' register and spill lines;
  3. K1 against its plain PyTorch version (`flash_attention_reference`) in bf16
     at the LTX serving path's shapes, with errors and median CUDA-event times;
  4. K2, K3 and the pre-pass against `flash_backward_reference` in bf16 at the
     training path's shapes (LTX self-attention with per-head RoPE tables,
     cross-attention with kv_lens, a ragged case with an empty row, H=128 with
     shared tables), with errors, times and the torch SDPA backward as a
     library yardstick;
  5. K6 against `sage_attention_reference` on the same int8 codes and scales
     (Wan self-attention with rotated q/k, Wan cross-attention over 512 text
     keys with kv_lens, LTX's self-attention shape, a ragged case with an empty
     row), and the quantization pre-pass on the card against the same torch ops
     on the CPU; times of K6, the pre-pass and the plain version, the bound and
     torch SDPA as a yardstick; then K1 at Wan's self-attention shape (H=128,
     one (S, H) table pair shared by every head) against its plain version,
     run head by head;
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
     CFG 3.0; checks the videos and that K1 was launched 2*28*steps*requests times;
     then one denoise step with K1 against plain fp32 attention, seconds per step
     and per request, peak memory, and a torch.profiler breakdown of one step;
  7. Wan serving through the user entry points: the full-width Wan 2.1
     T2V-1.3B spec (random weights, bf16, 30 blocks) serves 2 prompts at
     49x512x768 with CFG 5.0 and 4 steps under `attention_provider("sage")`:
     checks the videos and that K6 was launched 2*30*steps*requests times and
     K1 never; one request under the default provider (K1, 2*30*steps
     launches); one denoise step with K6 against the same step with K1;
     seconds per step and per request, peak memory, and a torch.profiler
     breakdown of one sage step (K6, pre-pass, rotation, GEMMs, the rest);
  8. training through the user entry points: `SFTTrainer` on the full-width spec
     with LoRA rank 128, one warm-up and 5 timed steps on seeded VAE moments
     (1, 256, 7, 16, 24) -> 2688 tokens and seeded caption states with a padded
     mask; checks finite losses, moved LoRA factors, unchanged frozen weights
     and 2*28 launches of K1, K2 and K3 per step; then one step's loss and LoRA
     gradient with the kernels against plain fp32 attention (both under per-block
     "full" remat), and a torch.profiler breakdown of one train step;
  9. Wan LoRA training through the user entry points: `SFTTrainer` on the
     full-width Wan 2.1 T2V-1.3B spec (rank 32, the optimizer of
     examples/training/sft/wan/crush_smol_lora/train.sh, logit-normal
     weighting, per-block "full" remat) on seeded VAE moments (1, 32, 13, 64,
     96) -> 19968 tokens and 512 valid caption tokens: one warm-up and 3 timed
     steps (finite losses, moved LoRA factors, unchanged frozen weights, K1
     4*30 and the pre-pass, K2, K3 2*30 launches per step, model TFLOP/s by
     tools/floor_bench.py's formula); the same step under
     FINETRAINERS_FLASH_FUSED_BWD (K5: bit-equal loss, LoRA gradient within
     1e-2, 2*30 K5 launches, its step time) and under each forward switch
     (K7a/b/c launch counts, loss within 1e-3 and gradient within 2e-2 of the
     K1 step); the kernel step against plain fp32 attention at 4992 tokens;
     host issue time and a torch.profiler breakdown of one step.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is not
0. Without a CUDA card it raises before printing any result.
"""

import contextlib
import json
import os
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
from finetrainers_tpu_torch.ops import sage_attention as sage_ops
from finetrainers_tpu_torch.ops.flash_attention import (
    _rope_bwd,
    flash_attention_reference,
    flash_backward,
    flash_backward_fused_reference,
    flash_backward_reference,
    flash_bwd_dkdv,
    flash_bwd_dq,
    flash_bwd_dq_emit,
    flash_bwd_fused,
    flash_bwd_prep,
    flash_bwd_prep_reference,
    flash_forward,
    flash_forward_skew,
    flash_forward_skew_reference,
    flash_forward_two_level,
    flash_forward_two_level_reference,
    flash_forward_twopass,
    flash_forward_twopass_reference,
)
from finetrainers_tpu_torch.ops.sage_attention import sage_attention_reference, sage_forward, sage_quantize
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


_KERNEL_CLASSES = (("k1", "flash_fwd_kernel"), ("k2", "bwd_dkdv_kernel"), ("k3", "bwd_dq_kernel"),
                   ("bwd_prep", "rope_prep_kernel"), ("k6", "sage_fwd_kernel"))


@contextlib.contextmanager
def annotated(module, name, label):
    """Wrap `module.name` in a torch.profiler range `label` for the duration,
    so the kernels a torch-ops stage launches can be told apart in a trace."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def profile_device(fn, ranges=()):
    """Device time of one call of `fn` by class from torch.profiler: the port's
    kernels (each launch kept in launch order), the kernels inside each of the
    user ranges named in `ranges` (by the range's device-side span), cuBLAS
    GEMMs, everything else."""
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
    classes.update({label: 0.0 for label in ranges})
    events = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
    # A user annotation (e.g. "Optimizer.step#AdamW.step") spans the kernels it encloses.
    spans = [(evt.name, evt.time_range.start, evt.time_range.end) for evt in events
             if getattr(evt, "is_user_annotation", False) and evt.name in ranges]
    for evt in events:
        if getattr(evt, "is_user_annotation", False):
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        name = evt.name.lower()
        kernels[evt.name[:90]] = kernels.get(evt.name[:90], 0.0) + ms
        cls = next((c for c, pattern in _KERNEL_CLASSES if pattern in name), None)
        span = next((label for label, t0, t1 in spans if t0 <= evt.time_range.start < t1), None)
        if cls is not None:
            launches[cls].append((evt.time_range.start, ms))
        elif span is not None:
            classes[span] += ms
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
            classes["gemm"] += ms
        else:
            classes["other"] += ms
    launches = {cls: [ms for _, ms in sorted(v)] for cls, v in launches.items()}
    busy = sum(classes.values()) + sum(sum(v) for v in launches.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms if busy else None,
                classes=classes, launches=launches, top_kernels_ms=top, device_events=len(kernels),
                annotated_ranges=len(spans))


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


def ltx_tables(n, h):
    rope = LTXRotaryPosEmbed(n * h)
    cos, sin = rope.numpy_tables(7, 16, 24, (8 / 25, 32.0, 32.0))
    return tuple(torch.from_numpy(t).cuda().reshape(2688, n, h).transpose(0, 1).contiguous() for t in (cos, sin))


def check_k1(card):
    """K1 against its reference at the serving path's shapes; returns the worst
    error and the self-attention record."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cos_t, sin_t = ltx_tables(32, 64)
    cases = {
        "self_rope": dict(b=2, n=32, sq=2688, skv=2688, lens=None, rope=(cos_t, sin_t)),
        "cross_kv_lens": dict(b=2, n=32, sq=2688, skv=128, lens=[1, 12], rope=None),
        "ragged": dict(b=2, n=32, sq=1000, skv=77, lens=[77, 30], rope=None),
    }
    worst, records = 0.0, {}
    for name, c in cases.items():
        # BTNH buffers viewed as BNSH, the layout the model hands the kernel.
        q, k, v = (torch.randn(c["b"], s, c["n"], 64, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for s in (c["sq"], c["skv"], c["skv"]))
        lens = None if c["lens"] is None else torch.tensor(c["lens"], dtype=torch.int32, device="cuda")
        cs, sn = c["rope"] or (None, None)
        out, lse = flash_forward(q, k, v, lens, cs, sn)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, lens, cs, sn)
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        norm_err = (err / ref.float().abs().clamp_min(1.0)).max().item()
        rel = max_abs / ref.float().abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ms = cuda_ms(lambda: flash_forward(q, k, v, lens, cs, sn))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, lens, cs, sn), iters=5)
        # The "native" provider (torch SDPA), a library baseline without the fused rotation, for comparison only.
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: attention_dispatch(qt, kt, vt, kv_lens=lens, provider="native"))
        kv_eff = sum(c["lens"]) if c["lens"] else c["b"] * c["skv"]
        flops = 4 * c["n"] * c["sq"] * kv_eff * 64
        q_bytes, kv_bytes = c["b"] * c["n"] * c["sq"] * 64 * 2, c["n"] * kv_eff * 64 * 2
        table_bytes = 2 * cs.numel() * 4 if cs is not None else 0
        bound_ms, bound_by = bound(flops, 2 * q_bytes + 2 * kv_bytes + c["b"] * c["n"] * c["sq"] * 4 + table_bytes)
        phase("k1_check", case=name, shape=[c["b"], c["n"], c["sq"], c["skv"], 64], kv_lens=c["lens"],
              max_abs_err=max_abs, rel_err=rel, err_over_max1_ref=norm_err, lse_max_abs_err=lse_err,
              ms=ms, plain_ms=plain_ms, sdpa_baseline_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
              tflops=flops / ms / 1e9, card=card)
        if not (norm_err <= K1_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"K1 disagrees with its reference on {name}: {norm_err} > {K1_TOL} or "
                                 f"LSE {lse_err} > {LSE_TOL}")
        worst = max(worst, max_abs)
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by)
    return worst, records["self_rope"]


def check_k2k3(card):
    """The pre-pass, K2 and K3 against their plain versions at the training
    path's shapes; returns the worst errors and the self-attention records."""
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {
        "self_rope": dict(b=1, n=32, sq=2688, skv=2688, h=64, lens=None, rope="ltx"),
        "cross_kv_lens": dict(b=1, n=32, sq=2688, skv=128, h=64, lens=[37], rope=None),
        "ragged_empty_row": dict(b=2, n=32, sq=1000, skv=77, h=64, lens=[77, 0], rope=None),
        "h128_shared_rope": dict(b=1, n=12, sq=4096, skv=4096, h=128, lens=None, rope="shared"),
    }
    worst = {"prep": 0.0, "k2": 0.0, "k3": 0.0}
    records = {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for s in (sq, skv, skv))
        do = torch.randn(b, sq, n, h, generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
        lens = None if c["lens"] is None else torch.tensor(c["lens"], dtype=torch.int32, device="cuda")
        cos = sin = None
        if c["rope"] == "ltx":
            cos, sin = ltx_tables(n, h)
        elif c["rope"] == "shared":
            ang = torch.rand(1, sq, h // 2, generator=g, device="cuda") * 6.3
            cos, sin = (f(ang).repeat_interleave(2, -1).contiguous() for f in (torch.cos, torch.sin))
        rope_sn = 0 if cos is None or cos.shape[0] == 1 else sq * h
        scale = h**-0.5
        out, lse = flash_forward(q, k, v, lens, cos, sin)
        delta = (do.float() * out.float()).sum(-1)

        grads = flash_backward(q, k, v, out, lse, do, lens, cos, sin)
        q_s, k_r = flash_bwd_prep(q, k, cos, sin, rope_sn, scale)
        torch.cuda.synchronize()
        refs = flash_backward_reference(q, k, v, out, lse, do, lens, cos, sin)
        ref_qs, ref_kr = flash_bwd_prep_reference(q, k, cos, sin, scale)
        errors = {gname: rel_errors(got, ref) for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs)}
        errors["q_s"] = rel_errors(q_s, ref_qs)
        if cos is not None:
            errors["k_r"] = rel_errors(k_r, ref_kr)
        finite = all(bool(torch.isfinite(x).all()) for x in (*grads, q_s, k_r))

        prep_ms = cuda_ms(lambda: flash_bwd_prep(q, k, cos, sin, rope_sn, scale))
        prep_plain_ms = cuda_ms(lambda: flash_bwd_prep_reference(q, k, cos, sin, scale))
        k2_ms = cuda_ms(lambda: flash_bwd_dkdv(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn))
        k3_ms = cuda_ms(lambda: flash_bwd_dq(q_s, k_r, v, do, lse, delta, lens, cos, sin, rope_sn, scale))
        backward_ms = cuda_ms(lambda: flash_backward(q, k, v, out, lse, do, lens, cos, sin))
        plain_ms = cuda_ms(lambda: flash_backward_reference(q, k, v, out, lse, do, lens, cos, sin), iters=3)
        # torch SDPA's backward (dq, dk, dv in one call, no fused rotation): a library yardstick only.
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))

        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        q_bytes, kv_eff_bytes, kv_bytes = b * n * sq * h * 2, n * kv_eff * h * 2, b * n * skv * h * 2
        row_bytes = b * n * sq * 4
        table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
        k2_bound = bound(8 * n * sq * kv_eff * h, 2 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + 2 * kv_bytes
                         + table_bytes)
        k3_bound = bound(6 * n * sq * kv_eff * h, 3 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + table_bytes)
        prep_bound = bound(0, 2 * q_bytes + (2 * kv_bytes + table_bytes if cos is not None else 0))
        phase("k2k3_check", case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              rel_l2={k_: e[0] for k_, e in errors.items()}, max_err_over_max_ref={k_: e[1] for k_, e in errors.items()},
              max_abs_err={k_: e[2] for k_, e in errors.items()}, finite=finite,
              prep_ms=prep_ms, prep_plain_ms=prep_plain_ms, k2_ms=k2_ms, k3_ms=k3_ms, flash_backward_ms=backward_ms, plain_ms=plain_ms,
              sdpa_backward_ms=sdpa_bwd_ms, k2_bound_ms=k2_bound[0], k3_bound_ms=k3_bound[0],
              prep_bound_ms=prep_bound[0], k2_tflops=8 * n * sq * kv_eff * h / k2_ms / 1e9,
              k3_tflops=6 * n * sq * kv_eff * h / k3_ms / 1e9, card=card)
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
        records[name] = dict(prep=(prep_ms, prep_plain_ms, None, *prep_bound), k2=(k2_ms, plain_ms, sdpa_bwd_ms, *k2_bound),
                             k3=(k3_ms, plain_ms, sdpa_bwd_ms, *k3_bound))
    return worst, records["self_rope"]


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


def check_prepass(q, k, lens, codes):
    """The pre-pass on the card against the same torch ops on the CPU: q codes
    and scales equal, k codes within one and different in at most 0.1% of
    entries (the smoothed k's mean is summed in another order), k scales
    within rtol 1e-5. Returns (share of k codes that differ, max k scale error)."""
    cpu = sage_quantize(q.cpu(), k.cpu(), lens.cpu())
    if not (torch.equal(codes[0].cpu(), cpu[0]) and torch.equal(codes[2].cpu(), cpu[2])):
        raise AssertionError("the pre-pass's q codes or scales differ between the card and the CPU")
    diff = (codes[1].cpu().int() - cpu[1].int()).abs()
    share = (diff > 0).float().mean().item()
    scale_err = ((codes[3].cpu() - cpu[3]).abs() / cpu[3]).max().item()
    if diff.max() > 1 or share > 1e-3 or scale_err > 1e-5:
        raise AssertionError(f"the pre-pass's k codes differ: max {diff.max().item()}, share {share}, "
                             f"scale rel err {scale_err}")
    return share, scale_err


def check_k6(card):
    """K6 against its plain version on the same codes and scales; returns the
    worst error and the records of the Wan self-attention case (K6, pre-pass)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = {
        "wan_self_rope": dict(b=2, n=12, sq=WAN_TOKENS, skv=WAN_TOKENS, h=128, lens=None, rope=True),
        "wan_cross_kv_lens": dict(b=2, n=12, sq=WAN_TOKENS, skv=512, h=128, lens=[1, 9], rope=False),
        "ltx_self": dict(b=2, n=32, sq=2688, skv=2688, h=64, lens=None, rope=False),
        "ragged_empty_row": dict(b=2, n=4, sq=1000, skv=77, h=128, lens=[77, 0], rope=False),
    }
    worst, records = 0.0, {}
    for name, c in cases.items():
        b, n, sq, skv, h = c["b"], c["n"], c["sq"], c["skv"], c["h"]
        # BTNH, as the model hands them over; k with a per-channel offset, which smooth-K removes.
        q, k, v = (torch.randn(b, s, n, h, generator=g, device="cuda").to(torch.bfloat16) for s in (sq, skv, skv))
        k = k + torch.randn(1, 1, n, h, generator=g, device="cuda").to(torch.bfloat16)
        if c["rope"]:  # the dispatcher's rotation of q and k before K6
            cos, sin = wan_tables()
            q, k = (attention_ops._rotate_interleaved_4d(x, cos, sin) for x in (q, k))
        lens = torch.tensor(c["lens"] or [skv] * b, dtype=torch.int32, device="cuda")
        vt = v.transpose(1, 2)
        codes = sage_quantize(q, k, lens)
        out = sage_forward(*codes, vt, lens)
        torch.cuda.synchronize()
        ref = sage_attention_reference(*codes, vt, lens)
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        norm_err = (err / ref.float().abs().clamp_min(1.0)).max().item()
        rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        empty_zero = all(not out[i].any() for i, length in enumerate(c["lens"] or []) if length == 0)
        code_share, scale_err = check_prepass(q, k, lens, codes)
        ms = cuda_ms(lambda: sage_forward(*codes, vt, lens))
        prepass_ms = cuda_ms(lambda: sage_quantize(q, k, lens))
        plain_ms = cuda_ms(lambda: sage_attention_reference(*codes, vt, lens), iters=1, warmup=0)
        # torch SDPA on the bf16 inputs (no quantization): a library yardstick only, never called by the port.
        mask = (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qt, kt = q.transpose(1, 2), k.transpose(1, 2)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=None if c["lens"] is None
                                                                 else mask))
        kv_eff = int(lens.sum())
        bound_ms, bound_by = k6_bound(n, sq, kv_eff, h, b * sq)
        elems = b * n * (sq + skv) * h
        prepass_bound_ms = (elems * 2 + elems + b * n * (sq + skv) * 4) / PEAK_BYTES_PER_S * 1e3
        phase("k6_check", case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              max_abs_err=max_abs, err_over_max1_ref=norm_err, rel_l2=rel_l2, empty_rows_zero=empty_zero,
              prepass_k_codes_differing=code_share, prepass_k_scale_rel_err=scale_err,
              ms=ms, prepass_ms=prepass_ms, plain_ms=plain_ms, sdpa_yardstick_ms=sdpa_ms, bound_ms=bound_ms,
              bound_by=bound_by, prepass_bound_ms=prepass_bound_ms,
              tops_equivalent=4 * n * sq * kv_eff * h / ms / 1e9, card=card)
        if not (norm_err <= K6_TOL and rel_l2 <= K6_REL_L2_TOL and empty_zero):
            raise AssertionError(f"K6 disagrees with its reference on {name}: {norm_err} > {K6_TOL}, "
                                 f"rel L2 {rel_l2} > {K6_REL_L2_TOL} or an empty row is not zero")
        worst = max(worst, max_abs)
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                             prepass_ms=prepass_ms, prepass_bound_ms=prepass_bound_ms)
        del q, k, v, vt, codes, out, ref, err
    return worst, records["wan_self_rope"]


def check_k1_wan(card):
    """K1 at Wan's self-attention shape (B=2, N=12, S=19968, H=128, one (S, H)
    table pair shared by every head) against its plain version, run one head
    at a time (all heads at once would need ~100 GB of fp32 scores)."""
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
    ms = cuda_ms(lambda: flash_forward(q, k, v, None, cos, sin))
    plain_ms = cuda_ms(plain, iters=1, warmup=0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: attention_dispatch(qt, kt, vt, provider="native"))
    flops = 4 * b * n * s * s * h
    bound_ms, bound_by = bound(flops, 4 * b * n * s * h * 2 + b * n * s * 4 + 2 * cos.numel() * 4)
    phase("k1_check", case="wan_self_rope_shared_tables", shape=[b, n, s, s, h], max_abs_err=max_abs,
          err_over_max1_ref=norm_err, rel_l2=rel_l2, lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
          sdpa_baseline_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9, card=card)
    if not (norm_err <= K1_TOL and rel_l2 <= K1_REL_L2_TOL and lse_err <= LSE_TOL):
        raise AssertionError(f"K1 disagrees with its reference at Wan's shape: {norm_err}, rel L2 {rel_l2} "
                             f"or LSE {lse_err}")
    return max_abs, dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by)


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
    return q, k, v, do, lens, cos, sin


def check_k5(card):
    """K5 and its dq emit (after the pre-pass) against K5's plain version and
    against K2+K3 at the training paths' shapes, including Wan's; returns the
    worst errors and the records of the Wan case (K5, emit, and K1/K2/K3 at
    Wan's training shape) and of LTX's self-attention."""
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
        q_s, k_r = flash_bwd_prep(q, k, cos, sin, rope_sn, scale)
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
        k1_ms = cuda_ms(lambda: flash_forward(q, k, v, lens, cos, sin))
        plain_ms = cuda_ms(lambda: flash_backward_fused_reference(q, k, v, out, lse, do, lens, cos, sin),
                           iters=1, warmup=0)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = None if lens is None else (torch.arange(skv, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
        sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        del sdpa_out, leaves

        kv_eff = sum(c["lens"]) if c["lens"] else b * skv
        q_bytes, kv_eff_bytes, kv_bytes = b * n * sq * h * 2, n * kv_eff * h * 2, b * n * skv * h * 2
        row_bytes = b * n * sq * 4
        table_bytes = 2 * cos.numel() * 4 if cos is not None else 0
        # K5: five products; reads q_s, dO, k_r, v, LSE, delta (and k's tables for dk), writes dk, dv and the
        # fp32 dq accumulator once each.
        k5_bound = bound(10 * n * sq * kv_eff * h, 2 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + 2 * kv_bytes
                         + 2 * q_bytes + table_bytes)
        emit_bound = bound(0, 2 * q_bytes + q_bytes + table_bytes)
        k2_bound = bound(8 * n * sq * kv_eff * h, 2 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + 2 * kv_bytes
                         + table_bytes)
        k3_bound = bound(6 * n * sq * kv_eff * h, 3 * q_bytes + 2 * kv_eff_bytes + 2 * row_bytes + table_bytes)
        k1_bound = bound(4 * n * sq * kv_eff * h, 2 * q_bytes + 2 * kv_eff_bytes + row_bytes + table_bytes)
        phase("k5_check", case=name, shape=[b, n, sq, skv, h], kv_lens=c["lens"], rope=c["rope"],
              rel_l2={k_: e[0] for k_, e in errors.items()}, max_err_over_max_ref={k_: e[1] for k_, e in errors.items()},
              max_abs_err={k_: e[2] for k_, e in errors.items()},
              vs_k2k3_rel_l2={k_: e[0] for k_, e in vs_split.items()},
              vs_k2k3_max_err_over_max_ref={k_: e[1] for k_, e in vs_split.items()},
              emit_rel_l2=emit_errors[0], emit_max_abs_err=emit_errors[2], finite=finite, k5_ms=k5_ms, emit_ms=emit_ms, emit_plain_ms=emit_plain_ms,
              fused_backward_ms=fused_backward_ms, k2k3_backward_ms=split_backward_ms, k2_ms=k2_ms, k3_ms=k3_ms,
              k1_ms=k1_ms, plain_ms=plain_ms, sdpa_backward_ms=sdpa_bwd_ms, sdpa_forward_ms=sdpa_fwd_ms,
              k5_bound_ms=k5_bound[0], emit_bound_ms=emit_bound[0], k2_bound_ms=k2_bound[0],
              k3_bound_ms=k3_bound[0], k1_bound_ms=k1_bound[0],
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
            k5=(k5_ms, plain_ms, sdpa_bwd_ms, *k5_bound), k5_emit=(emit_ms, emit_plain_ms, None, *emit_bound),
            k1=(k1_ms, None, sdpa_fwd_ms, *k1_bound), k2=(k2_ms, None, sdpa_bwd_ms, *k2_bound),
            k3=(k3_ms, None, sdpa_bwd_ms, *k3_bound), k2k3_backward_ms=split_backward_ms,
            fused_backward_ms=fused_backward_ms)
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
    flash_forward.launches = 0
    videos, request_s = [], []
    for seed, prompt in enumerate(PROMPTS):
        t0 = time.perf_counter()
        videos.append(pipe(prompt=prompt, seed=seed, **REQUEST))
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
    launches = flash_forward.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = 2 * NUM_LAYERS * NUM_STEPS * len(PROMPTS)
    # LTX_VAE_CONFIG's decoder uses four of its five spatial flags, so a 49x512x768
    # request decodes to 49x256x384, as in the JAX package (ROADMAP.md).
    shape_ok = all(v.shape == (49, 256, 384, 3) and v.dtype == np.uint8 for v in videos)
    differ = not np.array_equal(videos[0], videos[1])
    phase("serve", requests=len(PROMPTS), video_shape=list(videos[0].shape), dtype=str(videos[0].dtype),
          videos_differ=differ, k1_launches=launches, k1_launches_expected=expected,
          request_seconds=request_s, peak_memory_gb=peak_gb, card=card)
    if not (shape_ok and differ and launches == expected):
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
    # Every block launches K1 twice, self-attention then cross-attention.
    k1_self, k1_cross = _split(prof["launches"]["k1"], by_order=True)
    classes = dict(prof["classes"], k1_self_attention=sum(k1_self), k1_cross_attention=sum(k1_cross))
    phase("profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, k1_launches=[len(k1_self), len(k1_cross)],
          k1_ms_per_launch={"self_attention": _median(k1_self), "cross_attention": _median(k1_cross)},
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return launches


def wan_serve(card):
    """The Wan serving path under `sage`, then under the default provider;
    returns K6's and K1's launches in those runs."""
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
    videos, request_s, launches, peak_gb = run("sage", PROMPTS)
    per_request = 2 * WAN_LAYERS * WAN_STEPS
    shape_ok = all(v.shape == (49, 512, 768, 3) and v.dtype == np.uint8 for v in videos)
    differ = not np.array_equal(videos[0], videos[1])
    phase("wan_serve", provider="sage", requests=len(PROMPTS), video_shape=list(videos[0].shape),
          dtype=str(videos[0].dtype), videos_differ=differ, launches=launches,
          k6_launches_expected=per_request * len(PROMPTS), request_seconds=request_s, peak_memory_gb=peak_gb,
          card=card)
    if not (shape_ok and differ and launches["k6"] == per_request * len(PROMPTS) and launches["k1"] == 0):
        raise AssertionError("Wan serving under sage failed its checks")
    sage_launches = launches["k6"]
    del videos

    videos, auto_request_s, launches, auto_peak_gb = run("auto", PROMPTS[:1])
    phase("wan_serve", provider="auto", requests=1, video_shape=list(videos[0].shape), launches=launches,
          k1_launches_expected=per_request, request_seconds=auto_request_s, peak_memory_gb=auto_peak_gb, card=card)
    if not (videos[0].shape == (49, 512, 768, 3) and launches["k1"] == per_request and launches["k6"] == 0):
        raise AssertionError("Wan serving under the default provider failed its checks")
    auto_launches = launches["k1"]
    del videos

    ehs, mask = pipe.encode_prompt(PROMPTS[0], None, True)
    latents = torch.randn(pipe.latent_shape(49, 512, 768), generator=torch.Generator("cuda").manual_seed(7),
                          device="cuda")
    sigma = float(pipe.scheduler.inference_sigmas(WAN_STEPS)[1])
    with torch.inference_mode():
        step = lambda: pipe.denoise_step(latents, ehs, mask, WAN_REQUEST["guidance_scale"], sigma)  # noqa: E731
        k1_out = step()
        k1_step_ms = cuda_ms(step, iters=3, warmup=1)
        with attention_provider("sage"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k6_out = step()
            step_peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the transformer alone, without the decode
            k6_step_ms = cuda_ms(step, iters=3, warmup=1)
            with annotated(sage_ops, "sage_quantize", "sage_prepass"), \
                    annotated(attention_ops, "_rotate_interleaved_4d", "rope_rotate"):
                prof = profile_device(step, ranges=("sage_prepass", "rope_rotate"))
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
    # Every block launches K6 twice, self-attention then cross-attention.
    k6_self, k6_cross = _split(prof["launches"]["k6"], by_order=True)
    classes = dict(prof["classes"], k6_self_attention=sum(k6_self), k6_cross_attention=sum(k6_cross))
    phase("wan_profile", card=card, provider="sage", step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, k6_launches=[len(k6_self), len(k6_cross)],
          k6_ms_per_launch={"self_attention": _median(k6_self), "cross_attention": _median(k6_cross)},
          annotated_ranges=prof["annotated_ranges"], top_kernels_ms=prof["top_kernels_ms"],
          device_events=prof["device_events"])
    return sage_launches, auto_launches


_COUNTED = dict(k1=flash_forward, prep=flash_bwd_prep, k2=flash_bwd_dkdv, k3=flash_bwd_dq, k5=flash_bwd_fused,
                k5_emit=flash_bwd_dq_emit, k6=sage_forward, k7a=flash_forward_twopass, k7b=flash_forward_skew,
                k7c=flash_forward_two_level)


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
    expected = 2 * NUM_LAYERS * TRAIN_TIMED_STEPS
    flops = ltx_train_step_flops(spec.transformer_config, TRAIN_RANK, 0.0, B=1, S=2688, L_CTX=CAPTION_LEN)
    median_s = statistics.median(step_s)
    phase("train", card=card, steps=trainer.state.train_state.step, timed_steps=TRAIN_TIMED_STEPS,
          step_seconds=step_s, median_step_s=median_s, losses=losses, losses_finite=finite,
          lora_factors_moved=moved, frozen_weights_unchanged=frozen_same, launches=launches,
          launches_expected_each=expected, max_memory_allocated_gb=peak_gb, model_flops_per_step=flops,
          model_tflops=flops / median_s / 1e12, bf16_peak_tflops=PEAK_BF16_FLOPS / 1e12,
          share_of_peak=flops / median_s / PEAK_BF16_FLOPS)
    if not (finite and moved and frozen_same
            and all(v == (expected if k_ in ("k1", "prep", "k2", "k3") else 0) for k_, v in launches.items())):
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
          k1_launches_expected=4 * NUM_LAYERS, k2_k3_launches_expected=2 * NUM_LAYERS)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel_l2 <= STEP_REL_L2_TOL and grad_finite
            and remat_launches["k1"] == 4 * NUM_LAYERS
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
    for cls in ("k2", "k3", "bwd_prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=False)
        per_launch[cls] = {"self_attention": _median(self_ms), "cross_attention": _median(cross_ms)}
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
    per_step = dict(k1=4 * WAN_LAYERS, prep=2 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS)
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
    # same weights (before the fused-backward timed steps update them).
    for env, key, expected_k1, count in (("FINETRAINERS_FLASH_TWOPASS", "k7a", 0, 4 * WAN_LAYERS),
                                          ("FINETRAINERS_FLASH_SKEW", "k7b", 2 * WAN_LAYERS, 2 * WAN_LAYERS),
                                          ("FINETRAINERS_FLASH_TWOLEVEL", "k7c", 0, 4 * WAN_LAYERS)):
        loss, grad, variant_launches = loss_and_grad(env)
        loss_rel, grad_rel = abs(loss - split_loss) / abs(split_loss), rel_l2(grad, split_grad)
        del grad
        want = dict(k1=expected_k1, prep=2 * WAN_LAYERS, k2=2 * WAN_LAYERS, k3=2 * WAN_LAYERS, **{key: count})
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
    fused_expected = dict(k1=4 * WAN_LAYERS, prep=2 * WAN_LAYERS, k5=2 * WAN_LAYERS, k5_emit=2 * WAN_LAYERS)
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
            and small_launches["k1"] == 4 * WAN_LAYERS and small_launches["k2"] == 2 * WAN_LAYERS):
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
    for cls in ("k1", "k2", "k3", "bwd_prep"):
        self_ms, cross_ms = _split(prof["launches"][cls], by_order=False)
        per_launch[cls] = {"self_attention": _median(self_ms), "cross_attention": _median(cross_ms)}
    classes = dict(prof["classes"], **{cls: sum(v) for cls, v in prof["launches"].items()})
    phase("wan_train_profile", card=card, step_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
          idle_share=prof["idle_share"], ms_by_class=classes, host_seconds=host,
          launches={cls: len(v) for cls, v in prof["launches"].items()}, ms_per_launch=per_launch,
          top_kernels_ms=prof["top_kernels_ms"], device_events=prof["device_events"])
    return paths


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
    sources = ("flash_fwd", "flash_bwd", "sage_fwd")
    _build.load_libraries(sources)
    builds = {name: {"seconds": _build.BUILD_LOG[name]["seconds"],
                     "ptxas": [line.strip() for line in _build.BUILD_LOG[name]["log"].splitlines()
                               if "Used" in line or "spill" in line]}
              for name in sources}
    phase("build", seconds=time.perf_counter() - t0, kernels=builds)

    k1_err, k1 = check_k1(card)
    bwd_err, bwd = check_k2k3(card)
    k6_err, k6 = check_k6(card)
    k1_wan_err, k1_wan = check_k1_wan(card)
    k5_err, k5_wan, k5_ltx = check_k5(card)
    k7_err, k7 = check_k7(card)
    torch.cuda.empty_cache()
    serve_launches = serve(card)
    torch.cuda.empty_cache()
    wan_k6_launches, wan_k1_launches = wan_serve(card)
    torch.cuda.empty_cache()
    train_launches = train(card)
    torch.cuda.empty_cache()
    wan_paths = wan_train(card)

    def entry(name, source, replaces, launches, err, record, **extra):
        ms, plain_ms, library_ms, bound_ms, bound_by = record
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, **extra)

    def wan_shape(record):  # a K1/K2/K3 record of check_k5 at Wan's training shape (no plain version timed there)
        ms, _, library_ms, bound_ms, bound_by = record
        return dict(shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128], ms=ms, library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by)

    def k7_entry(key, name, replaces):
        r = k7[key]
        return entry(name, "finetrainers_tpu_torch/csrc/flash_fwd.cu", replaces, wan_paths[f"wan_train_{key}"][key],
                     k7_err[key], (r["ms"], r["plain_ms"], r["library_ms"], r["bound_ms"], r["bound_by"]),
                     launches_by_path={f"wan_train_{key}": wan_paths[f"wan_train_{key}"][key]},
                     by_case=r["by_case"], library_note="torch SDPA forward, without the fused rotation")

    wan = wan_paths["wan_train"]
    print(json.dumps({"kernels": [
        entry("flash_fwd (K1)", "finetrainers_tpu_torch/csrc/flash_fwd.cu",
              "finetrainers_tpu/ops/flash_attention.py:106", serve_launches, max(k1_err, k1_wan_err),
              (k1["ms"], k1["plain_ms"], k1["library_ms"], k1["bound_ms"], k1["bound_by"]),
              launches_by_path={"serve": serve_launches, "train": train_launches["k1"],
                                "wan_serve_default_provider": wan_k1_launches, "wan_train": wan["k1"]},
              wan_self_attention=k1_wan, wan_train_self_attention=wan_shape(k5_wan["k1"])),
        entry("flash_bwd_prep (K2/K3 RoPE and scale pre-pass)", "finetrainers_tpu_torch/csrc/flash_bwd.cu",
              "finetrainers_tpu/ops/flash_attention.py:961", train_launches["prep"], bwd_err["prep"], bwd["prep"],
              launches_by_path={"train": train_launches["prep"], "wan_train": wan["prep"],
                                "wan_train_fused_bwd": wan_paths["wan_train_fused_bwd"]["prep"]}),
        entry("bwd_dkdv (K2)", "finetrainers_tpu_torch/csrc/flash_bwd.cu",
              "finetrainers_tpu/ops/flash_attention.py:888", train_launches["k2"], bwd_err["k2"], bwd["k2"],
              launches_by_path={"train": train_launches["k2"], "wan_train": wan["k2"]},
              wan_train_self_attention=wan_shape(k5_wan["k2"])),
        entry("bwd_dq (K3)", "finetrainers_tpu_torch/csrc/flash_bwd.cu",
              "finetrainers_tpu/ops/flash_attention.py:1199", train_launches["k3"], bwd_err["k3"], bwd["k3"],
              launches_by_path={"train": train_launches["k3"], "wan_train": wan["k3"]},
              wan_train_self_attention=wan_shape(k5_wan["k3"]),
              k2_k3_backward_ms_at_wan_shape=k5_wan["k2k3_backward_ms"]),
        entry("bwd_fused (K5)", "finetrainers_tpu_torch/csrc/flash_bwd.cu",
              "finetrainers_tpu/ops/flash_attention.py:1038", wan_paths["wan_train_fused_bwd"]["k5"], k5_err["k5"],
              k5_wan["k5"], launches_by_path={"wan_train_fused_bwd": wan_paths["wan_train_fused_bwd"]["k5"]},
              shape=[1, 12, WAN_TOKENS, WAN_TOKENS, 128], fused_backward_ms=k5_wan["fused_backward_ms"],
              ltx_train_self_attention=dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                                k5_ltx["k5"])),
              library_note="torch SDPA backward (dq, dk, dv), without the fused rotation"),
        entry("bwd_fused dq emit (K5's scale, transpose rotation and cast of dq)",
              "finetrainers_tpu_torch/csrc/flash_bwd.cu", "finetrainers_tpu/ops/flash_attention.py:1191",
              wan_paths["wan_train_fused_bwd"]["k5_emit"], k5_err["k5_emit"], k5_wan["k5_emit"],
              launches_by_path={"wan_train_fused_bwd": wan_paths["wan_train_fused_bwd"]["k5_emit"]}),
        k7_entry("k7a", "fwd_twopass (K7a)", "finetrainers_tpu/ops/flash_attention.py:337"),
        k7_entry("k7b", "fwd_skew (K7b)", "finetrainers_tpu/ops/flash_attention.py:491"),
        k7_entry("k7c", "fwd two-level (K7c)", "finetrainers_tpu/ops/flash_attention.py:229"),
        entry("sage_fwd (K6)", "finetrainers_tpu_torch/csrc/sage_fwd.cu",
              "finetrainers_tpu/ops/sage_attention.py:36", wan_k6_launches, k6_err,
              (k6["ms"], k6["plain_ms"], k6["library_ms"], k6["bound_ms"], k6["bound_by"]),
              prepass_ms=k6["prepass_ms"], prepass_bound_ms=k6["prepass_bound_ms"],
              library_note="torch SDPA on the unquantized bf16 inputs: a yardstick only"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
