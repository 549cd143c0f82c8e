"""`chip_smoke.py`'s attention-branch phases alone on the card, for debugging
them without the script's earlier paths.

    python3 tools/torch_attention_branch_phases.py OUT.jsonl [branches] [dummy] [checkpoint]

Builds the kernels (`_build.load_libraries`, with each kernel's ptxas
registers and spills), then runs the named phases (all by default) in that
order: `branches` (`check_attention_branches`: the causal, segment and mask
branches of K1, K2 and K3 through `attention_dispatch` at Wan's, Llama-3's and
CogView4's widths), `dummy` (`dummy_run`, whose LoRA run is repeated under
`--attn_provider_training transformer:flash_varlen`) and `checkpoint`
(`cogview4_checkpoint_serve`, whose runner request is repeated under
`--attn_provider flex`). Prints the card's name and power limit, then one JSON
line per phase (cut at 2000 characters), each also written whole to
OUT.jsonl. Needs a CUDA card.
"""

import contextlib
import io
import json
import pathlib
import shutil
import subprocess
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402

out = pathlib.Path(sys.argv[1])
out.parent.mkdir(parents=True, exist_ok=True)
wanted = set(sys.argv[2:]) or {"branches", "dummy", "checkpoint"}
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
with out.open("w") as f:
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        t0 = time.perf_counter()
        sources = _build.SOURCES
        _build.load_libraries(sources)
        cs.phase("build", seconds=time.perf_counter() - t0,
                 kernels={name: {"seconds": _build.BUILD_LOG[name]["seconds"],
                                 **cs.ptxas_summary(_build.BUILD_LOG[name]["log"])} for name in sources})
        try:
            if "branches" in wanted:
                cs.check_attention_branches(card)
            if "dummy" in wanted:
                cs.dummy_run(card)
            if "checkpoint" in wanted:
                cs.cogview4_checkpoint_serve(card)
        finally:
            for line in buffer.getvalue().splitlines():
                f.write(line + "\n")
                print(line[:2000], file=sys.__stdout__, flush=True)
            shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
