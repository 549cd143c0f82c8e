"""`chip_smoke.py`'s CogVideoX phases alone on the card, for debugging them
without the script's earlier paths; with `policies`, also which remat policy
the crush_smol_lora example's step fits one card under at its bucket.

    python3 tools/torch_cogvideox_phases.py OUT.jsonl [policies] [kernels] [run] [serve]

Builds the kernels (`_build.load_libraries`), then runs the named phases
(`kernels`, `run` and `serve` by default) in that order: `policies`, then
`check_cogvideox_kernels`, `cogvideox_run` and `cogvideox_serve` (which
serves the adapter `cogvideox_run` exported). `policies` builds the
full-width CogVideoX-5B for LoRA training (rank 32, bf16, `transformer:auto`,
seeded frames-first moments and T5 states at 81x480x768, 30,466 tokens) and
times one step under "ops", "ops_narrow", "ops_attn" and "full" (the
example's policy first, then each that saves less), each after a warm-up
step, with its peak memory, or the out-of-memory error it raised. Prints the
card's name and power limit, then one JSON line per phase (cut at 2000
characters), each also written whole to OUT.jsonl. Needs a CUDA card.
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


def policies(card):
    """One LoRA step of the full-width model at the example's bucket under
    each of "ops", "ops_narrow", "ops_attn" and "full": seconds and peak
    memory, or the out-of-memory error."""
    from finetrainers_tpu_torch import get_model_specification_cls
    from finetrainers_tpu_torch.args import BaseArgs
    from finetrainers_tpu_torch.trainer import SFTTrainer

    g = torch.Generator(device="cuda").manual_seed(3)
    moments = torch.randn((1, 21, 32, 60, 96), generator=g, device="cuda")
    mask = torch.zeros((1, cs.COGVIDEOX_TEXT), dtype=torch.int32, device="cuda")
    mask[:, :12] = 1
    ehs = torch.randn((1, cs.COGVIDEOX_TEXT, 4096), generator=g, device="cuda") * 0.02 * mask[..., None]
    batch = ({"encoder_hidden_states": ehs, "encoder_attention_mask": mask}, {"latents": moments})
    spec = get_model_specification_cls("cogvideox", "lora")(device="cuda")
    trainer = SFTTrainer(BaseArgs(model_name="cogvideox", training_type="lora", rank=32, lora_alpha=32, seed=0,
                                  flow_weighting_scheme="logit_normal", gradient_checkpointing=True,
                                  gradient_checkpointing_type="ops", attn_provider_training=["transformer:auto"]),
                         spec)
    trainer.prepare()
    for policy in ("ops", "ops_narrow", "ops_attn", "full"):
        trainer.transformer.module.gradient_checkpointing = policy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        record = dict(policy=policy)
        try:
            trainer.train_step(*batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(*batch)
            torch.cuda.synchronize()
            record.update(step_s=time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as e:  # the measurement this probe is for: whether the policy fits
            record.update(out_of_memory=str(e).splitlines()[0])
        trainer.optimizer.zero_grad()
        record.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        phase("cogvideox_policy_probe", card=card, tokens=cs.COGVIDEOX_TOKENS, **record)
        cs._free_cuda()


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
which = sys.argv[2:] or ["kernels", "run", "serve"]
adapter = None
for name, fn in (("policies", lambda: policies(card)),
                 ("kernels", lambda: cs.check_cogvideox_kernels(card)),
                 ("run", lambda: cs.cogvideox_run(card)["adapter"]),
                 ("serve", lambda: cs.cogvideox_serve(card, adapter))):
    if name in which:
        t = time.perf_counter()
        result = fn()
        adapter = result if name == "run" else adapter
        phase("timing", part=name, seconds=time.perf_counter() - t)
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
