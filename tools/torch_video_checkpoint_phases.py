"""`chip_smoke.py`'s Wan and LTX-Video checkpoint phases alone on the card,
for debugging them without the script's earlier paths.

    python3 tools/torch_video_checkpoint_phases.py OUT.jsonl [wan] [ltx] [dtype] [frame_runs]

Builds the kernels (`_build.load_libraries`), writes `wan_run`'s two videos
(`wan_run_data`, which `wan_checkpoint_run` trains on), then runs the named
phases (the first three by default) in that order: `wan_checkpoint_run`,
`ltx_checkpoint_serve`, `video_dtype_check` and `frame_runs`, which times
`AutoencoderKLWan` at its published config in bf16 (a full-frame encode of
49x480x832, decodes to 49 and 81 frames at 480x832) with its causal convs,
norms and per-frame ops in runs of frames past `SPLIT_ELEMENTS` (the
default) and in one pass, and reads each one's peak memory (the two agree
within bf16's roundings). Prints the card's name and
power limit, then one JSON line per phase (cut at 2000 characters), each also
written whole to OUT.jsonl, and each part's seconds. Needs a CUDA card.
"""

import json
import pathlib
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402

out = pathlib.Path(sys.argv[1])
out.parent.mkdir(parents=True, exist_ok=True)
log = open(out, "w")


def phase(name, **fields):
    line = json.dumps({"phase": name, **fields}, default=str)
    log.write(line + "\n")
    log.flush()
    print(line[:2000], flush=True)


cs.phase = phase


def frame_runs():
    from finetrainers_tpu_torch.models import autoencoders
    from finetrainers_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig

    with torch.device("cuda"):
        vae = cs.init_parameters_(AutoencoderKLWan(WanVAEConfig(), torch.bfloat16),
                                  torch.Generator("cuda").manual_seed(41)).eval()
    default = autoencoders.SPLIT_ELEMENTS
    g = torch.Generator("cuda").manual_seed(42)
    cases = {"encode_49x480x832": (vae.encode, torch.rand((1, 3, 49, 480, 832), generator=g, device="cuda") * 2 - 1),
             "decode_49x480x832": (vae.decode, torch.randn((1, 16, 13, 60, 104), generator=g, device="cuda")),
             "decode_81x480x832": (vae.decode, torch.randn((1, 16, 21, 60, 104), generator=g, device="cuda"))}
    for name, (fn, x) in cases.items():
        record, outs = {}, {}
        for mode, split in (("frame_runs", default), ("one_pass", 1 << 62)):
            autoencoders.SPLIT_ELEMENTS = split
            try:
                with torch.no_grad():
                    fn(x)  # warm-up: cuDNN's algorithm choice
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    t = time.perf_counter()
                    outs[mode] = fn(x)
                    torch.cuda.synchronize()
                record[mode] = dict(seconds=time.perf_counter() - t,
                                    peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
            except torch.OutOfMemoryError as e:
                record[mode] = dict(out_of_memory=str(e)[:200])
            finally:
                autoencoders.SPLIT_ELEMENTS = default
            cs._free_cuda()
        if len(outs) == 2:
            a, b = outs["frame_runs"], outs["one_pass"]
            record["rel_l2_runs_vs_one_pass"] = ((a - b).norm() / b.norm()).item()
        del outs
        cs._free_cuda()
        phase("wan_vae_frame_runs", card=card, case=name, split_elements=default, **record)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
t0 = time.perf_counter()
_build.load_libraries(_build.SOURCES)
cs.wan_run_data(cs.SMOKE_DIR / "wan_run_data")
phase("build", seconds=time.perf_counter() - t0)
which = sys.argv[2:] or ["wan", "ltx", "dtype"]
for name, fn in (("wan", lambda: cs.wan_checkpoint_run(card)), ("ltx", lambda: cs.ltx_checkpoint_serve(card)),
                 ("dtype", lambda: cs.video_dtype_check(card)), ("frame_runs", frame_runs)):
    if name in which:
        t = time.perf_counter()
        fn()
        phase("timing", part=name, seconds=time.perf_counter() - t)
        cs._free_cuda()
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
