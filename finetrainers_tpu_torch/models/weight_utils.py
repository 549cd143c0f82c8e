"""Carry JAX (flax) parameters across into the port's modules.

The JAX package keeps parameters as a flax tree; the port's modules use
diffusers/peft names. `load_flax_state` takes the flattened tree
(`{"a.b.kernel": np.ndarray}`, keys joined by ".") and loads it strict:

  - names map through `flax_key_to_torch` (copied from
    `finetrainers_tpu/models/weight_utils.py:37-45`) or a per-model key map;
  - linear kernels (in, out) are transposed to torch's (out, in)
    (`weight_utils.py:80-81, 105-106`);
  - LoRA factors `lora_a` (in, r) / `lora_b` (r, out) become peft's
    `lora_A.weight` (r, in) / `lora_B.weight` (out, r) (`weight_utils.py:111-135`);
  - scan-stacked blocks `<list>_scan.block[_j].*` are split along their
    leading axis into `<list>_<i>.*` (`weight_utils.py:214-240`).

A local diffusers or Hugging Face checkpoint directory loads without the
bridge: the port's modules carry the checkpoints' names, so
`load_diffusers_checkpoint_dir` (JAX `weight_utils.py:300-327`) reads its
tensors and `load_named_weights` copies them into a module built on its device.
"""

from __future__ import annotations

import re
import json
import pathlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn


_BLOCK_LIST_NAMES = (
    "transformer_blocks", "single_transformer_blocks", "temporal_transformer_blocks",
    "blocks", "layers", "down_blocks", "up_blocks", "mid_blocks", "resnets",
)
_BLOCK_RE = re.compile(r"\b(" + "|".join(_BLOCK_LIST_NAMES) + r")_(\d+)\.")
_SCAN_RE = re.compile(r"^(?P<name>\w+?)_scan\.block(?:_(?P<j>\d+))?\.(?P<rest>.+)$")
_TORCH_BLOCK_RE = re.compile(r"\b(" + "|".join(_BLOCK_LIST_NAMES) + r")\.(\d+)\.")
_FLAX_BLOCK_RE = re.compile(r"^(?P<name>" + "|".join(_BLOCK_LIST_NAMES) + r")_(?P<i>\d+)\.(?P<rest>.+)$")


def flax_key_to_torch(flax_key: str) -> str:
    """transformer_blocks_0.attn1.to_q.kernel -> transformer_blocks.0.attn1.to_q.weight."""
    key = _BLOCK_RE.sub(r"\1.\2.", flax_key)
    key = key.replace(".kernel", ".weight")
    key = re.sub(r"\.scale$", ".weight", key)
    return key


def unstack_scanned(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Split `<list>_scan.block[_j].<rest>` stacks (leading layer axis) into
    per-block `<list>_<i>.<rest>` keys, i = step * group + j."""
    groups: Dict[str, int] = {}
    for key in flat:
        m = _SCAN_RE.match(key)
        if m:
            groups[m["name"]] = max(groups.get(m["name"], 1), int(m["j"] or 0) + 1)
    out: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        m = _SCAN_RE.match(key)
        if m is None:
            out[key] = value
            continue
        group, j = groups[m["name"]], int(m["j"] or 0)
        for step in range(value.shape[0]):
            out[f"{m['name']}_{step * group + j}.{m['rest']}"] = value[step]
    return out


def flax_to_torch_state_dict(flat: Dict[str, np.ndarray],
                             key_map: Optional[Callable[[str], str]] = None) -> Dict[str, np.ndarray]:
    """Flat flax parameters -> torch/peft-named arrays (linear kernels transposed)."""
    key_map = key_map or flax_key_to_torch
    out: Dict[str, np.ndarray] = {}
    for key, value in unstack_scanned(flat).items():
        value = np.asarray(value)
        base, _, leaf = key.rpartition(".")
        if leaf in ("lora_a", "lora_b"):
            torch_base = key_map(f"{base}.kernel")[: -len(".weight")]
            suffix = "lora_A.weight" if leaf == "lora_a" else "lora_B.weight"
            out[f"{torch_base}.{suffix}"] = value.T
        elif leaf == "kernel" and value.ndim == 2:
            out[key_map(key)] = value.T
        else:
            out[key_map(key)] = value
    return out


def load_torch_state(model: nn.Module, state: Dict[str, np.ndarray]) -> nn.Module:
    """Strict load of numpy arrays; each is cast to its parameter's dtype and device."""
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    model.load_state_dict(tensors, strict=True)
    return model


def load_flax_state(model: nn.Module, flat: Dict[str, np.ndarray],
                    key_map: Optional[Callable[[str], str]] = None) -> nn.Module:
    return load_torch_state(model, flax_to_torch_state_dict(flat, key_map))


def torch_key_to_flax(name: str, ndim: int, key_map: Callable[[str], str],
                      renames: Sequence[Tuple[str, str]] = ()) -> str:
    """The JAX package's flat name of the port's parameter `name` (the inverse
    of `key_map`, whose ordered `renames` it undoes): block lists `x.<i>.` ->
    `x_<i>.`, `weight` -> `kernel` (2D) or `scale` (a norm's). Raises
    KeyError where `key_map` does not give `name` back."""
    key = _TORCH_BLOCK_RE.sub(r"\1_\2.", name)
    for ours, theirs in reversed(renames):
        key = key.replace(theirs, ours)
    base, _, leaf = key.rpartition(".")
    if leaf == "weight":
        leaf = "kernel" if ndim == 2 else "scale"
    key = f"{base}.{leaf}"
    if key_map(key) != name:
        raise KeyError(f"{name}: no flax name maps to it (tried {key!r})")
    return key


def torch_to_flax_flat(state: Dict[str, np.ndarray], key_map: Callable[[str], str],
                       renames: Sequence[Tuple[str, str]] = (), stack_blocks: bool = False) -> Dict[str, np.ndarray]:
    """Port-named arrays -> the JAX package's flat flax names and layouts
    (linear weights transposed to (in, out)); with `stack_blocks` the
    per-block entries are stacked along a leading layer axis under
    `<list>_scan.block.<rest>`, as a JAX model that scans its blocks holds them."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in state.items():
        value = np.asarray(value)
        key = torch_key_to_flax(name, value.ndim, key_map, renames)
        flat[key] = value.T if key.endswith(".kernel") and value.ndim == 2 else value
    if not stack_blocks:
        return flat
    out: Dict[str, np.ndarray] = {}
    stacks: Dict[str, Dict[int, np.ndarray]] = {}
    for key, value in flat.items():
        m = _FLAX_BLOCK_RE.match(key)
        if m is None:
            out[key] = value
        else:
            stacks.setdefault(f"{m['name']}_scan.block.{m['rest']}", {})[int(m["i"])] = value
    for key, by_index in stacks.items():
        if sorted(by_index) != list(range(len(by_index))):
            raise ValueError(f"{key}: blocks {sorted(by_index)} are not 0..n-1, so they cannot be stacked")
        out[key] = np.stack([by_index[i] for i in range(len(by_index))])
    return out


def load_diffusers_checkpoint_dir(path: str) -> Dict[str, torch.Tensor]:
    """The merged state dict of a diffusers model directory: the shards its
    `diffusion_pytorch_model.safetensors.index.json` names, else every
    `diffusion_pytorch_model*.safetensors` (or, without those, every
    `*.safetensors`) in it (JAX `weight_utils.py:300-327`). CPU tensors in
    their stored dtypes; FileNotFoundError where the directory holds none."""
    from ..utils.serialization import safetensors_load_dict, safetensors_load_index

    root = pathlib.Path(path)
    index = root / "diffusion_pytorch_model.safetensors.index.json"
    if index.exists():
        return safetensors_load_index(str(index))
    shards = sorted(root.glob("diffusion_pytorch_model*.safetensors")) or sorted(root.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"No safetensors shards found under {path}")
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(safetensors_load_dict(str(shard)))
    return state


def load_diffusers_config(path: str) -> Dict[str, Any]:
    """The `config.json` of a model directory."""
    return json.loads((pathlib.Path(path) / "config.json").read_text())


def load_named_weights(module: nn.Module, state: Dict[str, torch.Tensor],
                       ignore_unexpected: bool = False) -> Tuple[str, ...]:
    """Copy a checkpoint's tensors into `module`'s parameters and buffers of the
    same names, each cast to its target's dtype on its target's device (the
    module is built where it will run; no fp32 copy is made on the host).
    Strict on every name and shape, except the LoRA factors (`lora_A`,
    `lora_B`), which keep their fresh init, as JAX's `torch_state_dict_to_flax`
    keeps them, and, with `ignore_unexpected`,
    checkpoint entries the module does not hold (a Hugging Face tower's
    `position_ids` buffer or `lm_head`, which JAX's converter skips too).
    Returns the ignored names."""
    targets = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    wanted = [name for name in targets if not any(f".{k}." in f".{name}." for k in ("lora_A", "lora_B"))]
    missing = [name for name in wanted if name not in state]
    unexpected = tuple(sorted(name for name in state if name not in targets))
    if missing or (unexpected and not ignore_unexpected):
        raise KeyError(f"checkpoint does not match {type(module).__name__}: {len(missing)} missing "
                       f"(e.g. {missing[:3]}), {len(unexpected)} unexpected (e.g. {list(unexpected[:3])})")
    with torch.no_grad():
        for name in wanted:
            target, value = targets[name], state[name]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)}, module {tuple(target.shape)}")
            target.copy_(value)
    return unexpected
