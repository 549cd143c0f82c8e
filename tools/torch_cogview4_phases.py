"""`chip_smoke.py`'s CogView4 and control phases alone on the card, for
debugging them without the script's earlier paths.

    python3 tools/torch_cogview4_phases.py OUT.jsonl [kernels] [run] [serve] [wan_control]

Builds the kernels (`_build.load_libraries`), then runs the named phases (all
four by default) in that order: `check_cogview4_kernels`,
`cogview4_control_run`, `cogview4_serve` (which serves the adapter and the
control image `cogview4_control_run` wrote, so it needs `run`) and
`wan_control_run`. Prints the card's name and power limit, then one JSON line
per phase (cut at 2000 characters), each also written whole to OUT.jsonl, and
each part's seconds. Needs a CUDA card.
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
    line = json.dumps({"phase": name, **fields})
    log.write(line + "\n")
    log.flush()
    print(line[:2000], flush=True)


cs.phase = phase
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
t0 = time.perf_counter()
_build.load_libraries(_build.SOURCES)
phase("build", seconds=time.perf_counter() - t0)
which = sys.argv[2:] or ["kernels", "run", "serve", "wan_control"]
run = None
for name, fn in (("kernels", lambda: cs.check_cogview4_kernels(card)),
                 ("run", lambda: cs.cogview4_control_run(card)),
                 ("serve", lambda: cs.cogview4_serve(card, run["adapter"], run["edge_map"])),
                 ("wan_control", lambda: cs.wan_control_run(card))):
    if name in which:
        t = time.perf_counter()
        result = fn()
        run = result if name == "run" else run
        phase("timing", part=name, seconds=time.perf_counter() - t)
        cs._free_cuda()
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
