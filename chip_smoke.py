"""Smoke run of the PyTorch port on one CUDA card: LTX-Video text-to-video serving.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
  2. the nvcc build of the hand-written kernel K1 (`csrc/flash_fwd.cu`), timed;
  3. K1 against its plain PyTorch version (`flash_attention_reference`) in bf16
     at the main path's shapes, with errors and median CUDA-event times;
  4. the slice through the user entry points: the full-width LTX spec (random
     weights from a seeded generator, bf16) serves 2 prompts at 49x512x768 with
     CFG 3.0; checks the videos and that K1 was launched 2*28*steps*requests times;
  5. one denoise step with K1 against the same step with plain fp32 attention;
  6. seconds per denoise step and per request, and peak device memory;
  7. one denoise step under torch.profiler: device time by kernel class and
     the card's idle share.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is not
0. Without a CUDA card it raises before printing any result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.models.ltx_video.transformer import LTXRotaryPosEmbed
from finetrainers_tpu_torch.ops import _build, attention_dispatch, attention_provider
from finetrainers_tpu_torch.ops.flash_attention import flash_attention_reference, flash_forward

NUM_STEPS = 8  # cut from the pipeline's default 50 to keep the run short
NUM_LAYERS = 28
PROMPTS = ("a red fox runs through fresh snow at dawn", "waves break on a rocky shore under a grey sky")
REQUEST = dict(num_frames=49, height=512, width=768, guidance_scale=3.0, num_inference_steps=NUM_STEPS)
# K1 (bf16 output) against the fp32 reference: |out - ref| <= K1_TOL * max(1, |ref|) elementwise,
# i.e. about two units in the last place of a bf16 value.
K1_TOL = 2e-2
LSE_TOL = 1e-2
STEP_REL_L2_TOL = 5e-2


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


def profile_step(step):
    """Device time of one denoise step by kernel class, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    classes, kernels, k1 = {}, {}, []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        name = evt.name.lower()
        kernels[evt.name[:90]] = kernels.get(evt.name[:90], 0.0) + ms
        if "flash_fwd_kernel" in name:
            k1.append((evt.time_range.start, ms))
            continue
        cls = "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")) else "other"
        classes[cls] = classes.get(cls, 0.0) + ms
    # Every block launches K1 twice, self-attention then cross-attention, so in
    # launch order the even K1 launches are self-attention and the odd ones cross.
    k1.sort()
    k1_self, k1_cross = [ms for _, ms in k1[0::2]], [ms for _, ms in k1[1::2]]
    classes["k1_self_attention"], classes["k1_cross_attention"] = sum(k1_self), sum(k1_cross)
    busy = sum(classes.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return dict(step_wall_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms if busy else None,
                ms_by_class=classes, k1_launches=[len(k1_self), len(k1_cross)],
                k1_ms_per_launch={"self_attention": statistics.median(k1_self) if k1_self else None,
                                  "cross_attention": statistics.median(k1_cross) if k1_cross else None},
                top_kernels_ms=top, device_events=len(kernels))


def check_k1(card):
    """K1 against its reference at the main path's shapes; returns the worst error
    and the self-attention times."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rope = LTXRotaryPosEmbed(32 * 64)
    cos, sin = rope.numpy_tables(7, 16, 24, (8 / 25, 32.0, 32.0))
    cos_t = torch.from_numpy(cos).cuda().reshape(2688, 32, 64).transpose(0, 1).contiguous()
    sin_t = torch.from_numpy(sin).cuda().reshape(2688, 32, 64).transpose(0, 1).contiguous()
    cases = {
        "self_rope": dict(b=2, n=32, sq=2688, skv=2688, lens=None, rope=(cos_t, sin_t)),
        "cross_kv_lens": dict(b=2, n=32, sq=2688, skv=128, lens=[1, 12], rope=None),
        "ragged": dict(b=2, n=32, sq=1000, skv=77, lens=[77, 30], rope=None),
    }
    worst, timing = 0.0, {}
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
        flops = 4 * c["b"] * c["n"] * c["sq"] * c["skv"] * 64
        phase("k1_check", case=name, shape=[c["b"], c["n"], c["sq"], c["skv"], 64], kv_lens=c["lens"],
              max_abs_err=max_abs, rel_err=rel, err_over_max1_ref=norm_err, lse_max_abs_err=lse_err,
              ms=ms, plain_ms=plain_ms, sdpa_baseline_ms=sdpa_ms, tflops=flops / ms / 1e9, card=card)
        if not (norm_err <= K1_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"K1 disagrees with its reference on {name}: {norm_err} > {K1_TOL} or "
                                 f"LSE {lse_err} > {LSE_TOL}")
        worst = max(worst, max_abs)
        timing[name] = (ms, plain_ms)
    return worst, timing["self_rope"]


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
    _build.load_library("flash_fwd")
    ptxas = [line.strip() for line in _build.BUILD_LOG["flash_fwd"]["log"].splitlines() if "Used" in line]
    phase("build", kernel="flash_fwd", seconds=time.perf_counter() - t0, ptxas=ptxas)

    k1_err, (k1_ms, k1_plain_ms) = check_k1(card)

    t0 = time.perf_counter()
    spec = get_model_specification_cls("ltx_video", "lora")(device=torch.device("cuda"), seed=0)
    pipe = spec.load_pipeline()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.transformer.module.parameters())
    phase("load", seconds=time.perf_counter() - t0, transformer_params=n_params,
          layers=len(pipe.transformer.module.transformer_blocks))
    if n_params != 1_923_385_472 or len(pipe.transformer.module.transformer_blocks) != NUM_LAYERS:
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
        breakdown = profile_step(step)
    rel_l2 = ((kernel_out - plain_out).norm() / plain_out.norm()).item()
    sdpa_rel_l2 = ((sdpa_out - plain_out).norm() / plain_out.norm()).item()
    phase("step_vs_plain_attention", rel_l2=rel_l2, bound=STEP_REL_L2_TOL, sdpa_baseline_rel_l2=sdpa_rel_l2,
          finite=bool(torch.isfinite(kernel_out).all()))
    if not (rel_l2 <= STEP_REL_L2_TOL and torch.isfinite(kernel_out).all()):
        raise AssertionError(f"denoise step with K1 differs from plain attention: rel L2 {rel_l2}")

    phase("timing", card=card, denoise_step_s=step_ms / 1e3, denoise_step_plain_attention_s=plain_step_ms / 1e3,
          request_s=statistics.mean(request_s), requests_s=request_s, steps_per_request=NUM_STEPS,
          peak_memory_gb=peak_gb, k1_self_attention_ms=k1_ms, k1_plain_ms=k1_plain_ms,
          denoise_step_sdpa_baseline_s=sdpa_step_ms / 1e3)
    phase("profile", card=card, **breakdown)

    print(json.dumps({"kernels": [{
        "name": "flash_fwd (K1)",
        "route": "cuda",
        "source": "finetrainers_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "finetrainers_tpu/ops/flash_attention.py:106",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
