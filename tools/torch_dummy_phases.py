"""`chip_smoke.py`'s head-dim-32 and dummy-family phases, and its CogView4
int8-storage phases, alone on the card, for debugging them without the
script's earlier paths.

    python3 tools/torch_dummy_phases.py OUT.jsonl [kernels] [dummy] [cogview4] [diagnose]

Builds the kernels (`_build.load_libraries`, with each kernel's ptxas
registers and spills), then runs the named phases (all by default) in that
order: `kernels` (`check_h32_kernels`), `dummy` (`dummy_run`, then
`dummy_serve` with its adapter) and `cogview4` (`cogview4_sft_run`, then
`cogview4_sft_serve` with its adapter). `diagnose` (not run by default) takes
the raider example's run for one step (its flags, int8 storage, random LoRA
factors from seed 8, the draws of a generator seeded 7, one batch of seeded
moments at its bucket) with `int8_linear`'s input gradient taken on the
dequantized weight in bf16 (the cotangent left unquantized), and the same
step as the run takes it and bf16-stored: where the int8 step's LoRA-gradient
error comes from. Prints the card's name and power
limit, then one JSON line per phase (cut at 2000 characters), each also
written whole to OUT.jsonl. Needs a CUDA card.
"""

import contextlib
import io
import json
import pathlib
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from finetrainers_tpu_torch.ops import _build  # noqa: E402

out = pathlib.Path(sys.argv[1])
out.parent.mkdir(parents=True, exist_ok=True)
wanted = set(sys.argv[2:]) or {"kernels", "dummy", "cogview4"}


def diagnose():
    """The raider step's LoRA-gradient error under int8 storage, with and without
    the cotangent quantization of `int8_linear`'s input gradient, against the
    bf16-stored step."""
    from finetrainers_tpu_torch.ops.int8_linear import Int8Linear

    g = torch.Generator(device="cuda").manual_seed(8)
    argv = cs.train_sh_argv(cs.RAIDER_EXAMPLE, dataset_config="unused.json", validation_dataset_file="unused.json",
                            output_dir=cs.SMOKE_DIR / "diagnose")
    moments = torch.randn((1, 32, 160, 90), generator=g, device="cuda")
    moments[:, 16:] = 0.5 * moments[:, 16:] - 2.0
    sizes = torch.tensor([[1280.0, 720.0]], device="cuda")
    ehs = torch.randn((1, cs.COGVIEW4_TEXT, 4096), generator=g, device="cuda") * 0.02
    batch = ({"encoder_hidden_states": ehs}, {"latents": moments, "original_size": sizes, "target_size": sizes,
                                              "crop_coords": torch.zeros_like(sizes)})
    shapes = {}
    lora = None
    results = {}
    orig = Int8Linear.backward

    def dequantized_dx(ctx, dy):
        wq, sw = ctx.saved_tensors
        return dy @ (wq.to(dy.dtype) * sw.to(dy.dtype)[:, None]), None, None

    for name, storage, patched in (("bf16", "bf16", False), ("int8", "int8", False),
                                   ("int8_dx_unquantized", "int8", True)):
        if lora is None:  # random factors, nonzero B, shared by every variant
            from finetrainers_tpu_torch.args import BaseArgs
            from finetrainers_tpu_torch.models.cogview4 import CogView4ModelSpecification

            spec = CogView4ModelSpecification(device="cuda")
            spec.lora_rank, spec.lora_alpha = cs.RAIDER_RANK, float(cs.RAIDER_RANK)
            module = spec.load_diffusion_models()["transformer"].module
            lora = {n: torch.randn(p.shape, generator=g, device="cuda") * 0.02
                    for n, p in module.named_parameters() if ".lora_" in n}
            shapes = len(lora)
            del module, spec
            cs._free_cuda()
        Int8Linear.backward = staticmethod(dequantized_dx) if patched else orig
        try:
            loss, grads, _, _ = cs.storage_step(argv, cs.SMOKE_DIR / f"diagnose_{name}", storage, lora, batch)
        finally:
            Int8Linear.backward = orig
        results[name] = (loss, grads)
    ref_loss, ref_grads = results["bf16"]
    cs.phase("diagnose_int8_gradient", factors=shapes, **{
        name: dict(loss_rel=abs(loss - ref_loss) / abs(ref_loss),
                   grad_rel_l2=((grads - ref_grads).norm() / ref_grads.norm()).item())
        for name, (loss, grads) in results.items() if name != "bf16"})
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)


class Tee(io.TextIOBase):
    """Phase lines to OUT.jsonl whole and to stdout cut at 2000 characters."""

    def __init__(self, log):
        self.log, self.stdout = log, sys.stdout

    def write(self, text):
        self.log.write(text)
        self.log.flush()
        for line in text.splitlines(keepends=True):
            self.stdout.write(line if len(line) <= 2000 else line[:2000] + "\n")
        self.stdout.flush()
        return len(text)


with open(out, "w") as log, contextlib.redirect_stdout(Tee(log)):
    sources = _build.SOURCES
    _build.load_libraries(sources)
    builds = {name: {"seconds": _build.BUILD_LOG[name]["seconds"], **cs.ptxas_summary(_build.BUILD_LOG[name]["log"])}
              for name in sources}
    cs.phase("build", kernels=builds)
    spilled = {name: rec for src in builds.values() for name, rec in src["ptxas"].items()
               if name.startswith(cs.NO_SPILL_KERNELS) and (rec.get("spill_stores") or rec.get("spill_loads"))}
    print(json.dumps({"phase": "spills", "spilled": spilled}), flush=True)
    if "kernels" in wanted:
        cs.check_h32_kernels(card)
    if "dummy" in wanted:
        run = cs.dummy_run(card)
        cs.dummy_serve(card, run["adapter"])
    if "cogview4" in wanted:
        sft = cs.cogview4_sft_run(card)
        cs.cogview4_sft_serve(card, sft["adapter"])
    if "diagnose" in wanted:
        diagnose()
shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
