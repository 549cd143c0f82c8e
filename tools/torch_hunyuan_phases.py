"""`chip_smoke.py`'s HunyuanVideo phases alone on the card, for debugging them
without the script's earlier paths; with `policies`, also what the example's
"ops" and the narrower "ops_narrow" remat policies need at its bucket.

    python3 tools/torch_hunyuan_phases.py OUT.jsonl [kernels] [run] [serve] [policies]

Builds the kernels (`_build.load_libraries`), then runs the named phases
(`kernels`, `run` and `serve` by default) in that order: `check_hunyuan_kernels`,
`hunyuan_run` and `hunyuan_serve` (which serves the adapter `hunyuan_run`
exported). `policies` builds the full-width model for LoRA training (rank 32,
bf16, `transformer:ring`, seeded moments and text states at 49x480x768) and
times one step under
"ops_attn", "ops_narrow" and "ops", each after a warm-up step, with its peak
memory, or the out-of-memory error it raised. Prints the card's name and power
limit, then one JSON line per phase (cut at 2000 characters), each also
written whole to OUT.jsonl. Needs a CUDA card.
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
    each of "ops_attn", "ops_narrow" and "ops": seconds and peak memory, or
    the out-of-memory error."""
    from finetrainers_tpu_torch import get_model_specification_cls
    from finetrainers_tpu_torch.args import BaseArgs
    from finetrainers_tpu_torch.trainer import SFTTrainer

    g = torch.Generator(device="cuda").manual_seed(3)
    moments = torch.randn((1, 32, 13, 60, 96), generator=g, device="cuda")
    mask = torch.zeros((1, cs.HUNYUAN_TEXT), dtype=torch.int32, device="cuda")
    mask[:, :cs.HUNYUAN_REFINER_VALID] = 1
    batch = ({"encoder_hidden_states": torch.randn((1, cs.HUNYUAN_TEXT, 4096), generator=g, device="cuda") * 0.02,
              "encoder_attention_mask": mask,
              "pooled_projections": torch.randn((1, 768), generator=g, device="cuda") * 0.02}, {"latents": moments})
    spec = get_model_specification_cls("hunyuan_video", "lora")(device="cuda")
    trainer = SFTTrainer(BaseArgs(model_name="hunyuan_video", training_type="lora", rank=32, lora_alpha=32, seed=0,
                                  flow_weighting_scheme="logit_normal", gradient_checkpointing=True,
                                  gradient_checkpointing_type="ops_attn", attn_provider_training=["transformer:ring"]),
                        spec)
    trainer.prepare()
    for policy in ("ops_attn", "ops_narrow", "ops"):
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
        phase("hunyuan_policy_probe", card=card, tokens=cs.HUNYUAN_TOKENS, **record)
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
for name, fn in (("kernels", lambda: cs.check_hunyuan_kernels(card)),
                 ("run", lambda: cs.hunyuan_run(card)["adapter"]),
                 ("serve", lambda: cs.hunyuan_serve(card, adapter)),
                 ("policies", lambda: policies(card))):
    if name in which:
        t = time.perf_counter()
        result = fn()
        adapter = result if name == "run" else adapter
        phase("timing", part=name, seconds=time.perf_counter() - t)
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
