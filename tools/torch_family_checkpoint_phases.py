"""`chip_smoke.py`'s CogVideoX, HunyuanVideo and Flux checkpoint phases alone
on the card, for debugging them without the script's earlier paths.

    python3 tools/torch_family_checkpoint_phases.py OUT.jsonl [cogvideox] [hunyuan] [flux] [dtype] [vae_decode]

Builds the kernels (`_build.load_libraries`), writes the media the phases
train on (`cogvideox_run_data`, `hunyuan_run_data`, `flux_run_data`), then runs
the named phases (the first four by default) in that order:
`cogvideox_checkpoint_run`, `hunyuan_checkpoint_run`, `flux_checkpoint_run`,
`video_dtype_check` and `vae_decode`, which times `AutoencoderKLCogVideoX`'s
decode to 81x480x768 and `AutoencoderKLHunyuanVideo`'s to 49x480x768 at their
published configs in bf16 (random weights and latents) with the frame runs
past `SPLIT_ELEMENTS` and reads each one's peak memory. Prints the card's
name and power limit, then one JSON line per phase (cut at 2000 characters),
each also written whole to OUT.jsonl, and each part's seconds. Needs a CUDA
card.
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


def vae_decode():
    from finetrainers_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from finetrainers_tpu_torch.models.hunyuan_video.vae import AutoencoderKLHunyuanVideo, HunyuanVAEConfig

    for name, cls, cfg, latents in (("cogvideox_81x480x768", AutoencoderKLCogVideoX, CogVideoXVAEConfig(),
                                     (1, 16, 21, 60, 96)),
                                    ("hunyuan_49x480x768", AutoencoderKLHunyuanVideo, HunyuanVAEConfig(),
                                     (1, 16, 13, 60, 96))):
        with torch.device("cuda"):
            vae = cs.init_parameters_(cls(cfg, torch.bfloat16), torch.Generator("cuda").manual_seed(43)).eval()
        z = torch.randn(latents, generator=torch.Generator("cuda").manual_seed(44), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        with torch.no_grad():
            video = vae.decode(z)
        torch.cuda.synchronize()
        phase("vae_decode", card=card, case=name, seconds=time.perf_counter() - t, shape=list(video.shape),
              peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9, finite=bool(torch.isfinite(video).all()))
        del vae, z, video
        cs._free_cuda()


card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
t0 = time.perf_counter()
_build.load_libraries(_build.SOURCES)
cs.cogvideox_run_data(cs.SMOKE_DIR / "cogvideox_run_data")
cs.hunyuan_run_data(cs.SMOKE_DIR / "hunyuan_run_data")
cs.flux_run_data(cs.SMOKE_DIR / "flux_run_data")
phase("build", seconds=time.perf_counter() - t0)
which = sys.argv[2:] or ["cogvideox", "hunyuan", "flux", "dtype"]
for name, fn in (("cogvideox", lambda: cs.cogvideox_checkpoint_run(card)),
                 ("hunyuan", lambda: cs.hunyuan_checkpoint_run(card)), ("flux", lambda: cs.flux_checkpoint_run(card)),
                 ("dtype", lambda: cs.video_dtype_check(card)), ("vae_decode", vae_decode)):
    if name in which:
        t = time.perf_counter()
        fn()
        phase("timing", part=name, seconds=time.perf_counter() - t)
        cs._free_cuda()
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
