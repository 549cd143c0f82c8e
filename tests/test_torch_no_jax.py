"""Guard: the PyTorch port imports no JAX and builds nothing at import time.

A fresh interpreter blocks `jax`, `flax`, `optax`, `finetrainers_tpu`,
`triton`, `safetensors` and `transformers` (a `None` entry in `sys.modules`
makes their import raise; the port reads and writes safetensors files
itself, and imports transformers' tokenizer only inside a tower handle's
load) and replaces
`subprocess` launches with a tripwire, then imports every module of
`finetrainers_tpu_torch`, the training slice's (trainer, optimizer, LoRA,
remat, diffusion math, the K4 op, checkpoints, the safetensors writer) and
the Wan serving slice's (int8 attention, Wan transformer, spec, pipeline)
and the data stage's (datasets, loader, sampler, precompute, prefetch,
trackers, the command line `finetrainers_tpu_torch.train`) and the Wan I2V
slice's (the multistep schedulers, the weight bridge, the inference runner
`finetrainers_tpu_torch.inference`) and the Flux slice's (transformer,
weights, spec, pipeline, the text processors) and the HunyuanVideo slice's
(transformer, weights, spec, pipeline) and the CogView4 and control slice's
(transformer, weights, specs, pipeline, the control trainer, its data and
config, the control processors, the Wan control spec) and the CogVideoX
slice's (transformer, weights, spec, DDIM pipeline) and the dummy and
weight-storage slice's (the dummy family, int8 linear, int8 and fp8
storage, the 8-bit optimizers) and the checkpoint slices' (the Llama, GLM,
CLIP text and T5/UMT5 towers and their handles, the 2D AutoencoderKL, the
Wan and LTX-Video VAEs) among them. Any
import of a blocked package, any `nvcc` run and any kernel library loaded
during import fails the test. A second fresh interpreter blocks nothing,
imports every module and finds neither `jax` nor `finetrainers_tpu` in
`sys.modules` afterwards. `chip_smoke.py` and the chip tools
(`tools/torch_*.py`) import no JAX either: a third interpreter blocks it and
imports `chip_smoke`, and no import line of theirs names it.
"""

import pathlib
import subprocess
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, subprocess, sys
for name in ("jax", "jaxlib", "flax", "optax", "finetrainers_tpu", "triton", "safetensors", "transformers"):
    sys.modules[name] = None

def _tripwire(*args, **kwargs):
    raise AssertionError(f"a process was started while importing the port: {args[:1]}")

subprocess.Popen = _tripwire
subprocess.run = _tripwire

import finetrainers_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from finetrainers_tpu_torch.ops import _build
assert not _build._LIBS, f"kernel libraries loaded at import: {list(_build._LIBS)}"
training = {"finetrainers_tpu_torch." + m for m in (
    "ops.flash_attention", "trainer.sft_trainer.trainer", "trainer.base", "optimizer", "lora", "args", "state",
    "utils.activation_checkpoint", "functional.diffusion", "ops.sage_attention", "models.wan.transformer",
    "models.wan.base_specification", "models.wan.pipeline", "checkpoint", "utils.serialization",
    "train", "constants", "trackers", "functional.text", "functional.image", "functional.video", "data.utils",
    "data.dataset", "data.sampler", "data.precomputation", "data.dataloader", "data.prefetch",
    "models.autoencoders", "utils.memory", "utils.timing", "utils.hub", "inference", "schedulers", "config",
    "models.wan.weights", "models.weight_utils", "models.layers", "models.flux", "models.flux.transformer",
    "models.flux.weights", "models.flux.base_specification", "models.flux.pipeline", "processors.text_encoders",
    "models.hunyuan_video", "models.hunyuan_video.transformer", "models.hunyuan_video.weights",
    "models.hunyuan_video.base_specification", "models.hunyuan_video.pipeline", "models.cogview4",
    "models.cogview4.transformer", "models.cogview4.weights", "models.cogview4.base_specification",
    "models.cogview4.pipeline", "models.cogview4.control_specification", "models.wan.control_specification",
    "models.cogvideox", "models.cogvideox.transformer", "models.cogvideox.weights",
    "models.cogvideox.base_specification", "models.cogvideox.pipeline",
    "trainer.control_trainer", "trainer.control_trainer.trainer", "trainer.control_trainer.data",
    "trainer.control_trainer.config", "processors.control", "models.dummy", "models.dummy.base_specification",
    "models.dummy.pipeline", "models.dummy.weights", "ops.int8_linear", "utils.int8", "utils.fp8", "optim8bit",
    "models.text_encoders", "models.text_encoders.towers", "models.text_encoders.handles", "models.autoencoder_kl",
    "models.wan.vae", "models.ltx_video.vae", "models.causal_vae", "models.cogvideox.vae",
    "models.hunyuan_video.vae")}
assert training <= set(names) and len(names) > 20, sorted(training - set(names))
print(len(names))
"""


def test_port_imports_without_jax_and_builds_nothing():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 20


_UNBLOCKED_PROBE = r"""
import importlib, pkgutil, sys
import finetrainers_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import finetrainers_tpu_torch.train
import finetrainers_tpu_torch.inference
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "finetrainers_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_leaves_jax_and_the_jax_package_out_of_sys_modules():
    res = subprocess.run([sys.executable, "-c", _UNBLOCKED_PROBE], cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.split()[-1] == "ok", res.stderr


def test_no_jax_import_lines_in_port_sources():
    bad = []
    for path in (REPO_ROOT / "finetrainers_tpu_torch").rglob("*.py"):
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            words = line.split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                root = words[1].split(".")[0].rstrip(",")
                if root in ("jax", "jaxlib", "flax", "optax", "finetrainers_tpu", "safetensors"):
                    bad.append(f"{path.relative_to(REPO_ROOT)}:{lineno}: {line.strip()}")
    assert not bad, bad


_CHIP_SMOKE_PROBE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "finetrainers_tpu"):
    sys.modules[name] = None
import chip_smoke
print("ok")
"""


def test_chip_smoke_and_chip_tools_import_no_jax():
    res = subprocess.run([sys.executable, "-c", _CHIP_SMOKE_PROBE], cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.split()[-1] == "ok", res.stderr
    bad = []
    for path in [REPO_ROOT / "chip_smoke.py", *sorted((REPO_ROOT / "tools").glob("torch_*.py"))]:
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            words = line.split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                if words[1].split(".")[0].rstrip(",") in ("jax", "jaxlib", "flax", "optax", "finetrainers_tpu"):
                    bad.append(f"{path.relative_to(REPO_ROOT)}:{lineno}: {line.strip()}")
    assert not bad, bad
