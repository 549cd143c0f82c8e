"""LoRA export and import: the port's safetensors writer and reader
(`utils/serialization.py`, no `safetensors` package) and `lora.py`, against
the `safetensors` package and the JAX package's `save_lora_weights`.

- The port's file is read by `safetensors.numpy.load_file` (values, dtypes
  F32/F16/BF16 through `safetensors.torch`), and the port reads files the
  package writes.
- For the same (bridged) LoRA factors of a tiny Wan and a tiny LTX model, the
  adapter the port's spec writes from its module has the key set, layouts
  and values of the one JAX's spec writes.
- For the same (bridged) parameters, the full-rank export the port's spec
  writes (`_save_model`: diffusion_pytorch_model.safetensors and
  config.json) has the key set, dtypes, shapes, values and config of the one
  JAX's spec writes.
- The port reads JAX's adapter, and each side reads the other's
  `lora_config` metadata.
- An adapter exported from a model and applied to a fresh model with the same
  base weights reproduces the first model's forward, bit-equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file

from finetrainers_tpu.lora import load_lora_weights as jax_load_lora_weights
from finetrainers_tpu.lora import save_lora_weights as jax_save_lora_weights
from finetrainers_tpu.models.ltx_video import LTXVideoModelSpecification as JaxLTXSpec
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxModelHandle
from finetrainers_tpu.models.modeling_utils import unflatten_params
from finetrainers_tpu.models.ltx_video import LTXVideoTransformer3DModel as JaxLTX
from finetrainers_tpu.models.wan import WanModelSpecification as JaxWanSpec
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.lora import (
    LORA_WEIGHTS_NAME,
    apply_lora_state_dict,
    extract_lora_state_dict,
    load_lora_weights,
    save_lora_weights,
)
from finetrainers_tpu_torch.models.ltx_video import load_flax_params as load_ltx_params
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle
from finetrainers_tpu_torch.models.wan import load_flax_params as load_wan_params
from finetrainers_tpu_torch.utils.serialization import (
    safetensors_load_dict,
    safetensors_load_metadata,
    safetensors_save_dict,
)
from test_torch_train_step import TINY as LTX_TINY
from test_torch_train_step import _jax_params as ltx_jax_params
from test_torch_wan_train_step import ALPHA, RANK, TINY, _jax_params

torch.set_num_threads(1)

CONFIG = {"r": RANK, "lora_alpha": ALPHA, "target_modules": "(transformer_blocks|blocks).*(to_q|to_k|to_v|to_out)"}
MODEL_WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"
FAMILIES = {
    "wan": (JaxWanSpec, JaxWan, TINY, _jax_params, load_wan_params),
    "ltx_video": (JaxLTXSpec, JaxLTX, LTX_TINY, ltx_jax_params, load_ltx_params),
}


def _flat(family):
    _, jax_cls, tiny, jax_params, _ = FAMILIES[family]
    return jax_params(jax_cls(**tiny, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32))


def _port_module(family, flat=None):
    spec = get_model_specification_cls(family, "lora")(device="cpu", transformer_config=FAMILIES[family][2],
                                                       transformer_dtype=torch.float32, lora_rank=RANK,
                                                       lora_alpha=ALPHA)
    module = spec.load_diffusion_models()["transformer"].module
    if flat is not None:
        FAMILIES[family][4](module, flat)
    return spec, module


def test_port_writer_is_read_by_the_safetensors_package(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"w32": torch.randn(3, 5, generator=g), "w16": torch.randn(4, generator=g).half(),
               "wbf": torch.randn(2, 3, 2, generator=g).bfloat16(), "scalar": torch.tensor(1.5),
               "view": torch.randn(5, 3, generator=g).t()}
    path = str(tmp_path / "port.safetensors")
    safetensors_save_dict(tensors, path, metadata={"lora_config": json.dumps(CONFIG)})
    loaded = torch_load_file(path)
    assert loaded.keys() == tensors.keys()
    for name, value in tensors.items():
        assert loaded[name].dtype == value.dtype and torch.equal(loaded[name], value), name
    np_loaded = np_load_file(path)
    np.testing.assert_array_equal(np_loaded["w32"], tensors["w32"].numpy())
    np.testing.assert_array_equal(np_loaded["view"], tensors["view"].numpy())
    # ... and the port reads the package's files.
    np_save_file({"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(3, np.float16)},
                 str(tmp_path / "pkg.safetensors"), metadata={"k": "v"})
    ours = safetensors_load_dict(str(tmp_path / "pkg.safetensors"))
    assert torch.equal(ours["a"], torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert ours["b"].dtype == torch.float16 and torch.equal(ours["b"], torch.ones(3, dtype=torch.float16))
    assert safetensors_load_metadata(str(tmp_path / "pkg.safetensors")) == {"k": "v"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_exported_adapter_equals_jax_export(family, tmp_path):
    jax_spec_cls = FAMILIES[family][0]
    flat = _flat(family)
    lora_flat = {k: v for k, v in flat.items() if k.endswith(("lora_a", "lora_b"))}
    jax_spec_cls(transformer_config=FAMILIES[family][2])._save_lora_weights(str(tmp_path / "jax"), lora_flat, CONFIG)
    spec, module = _port_module(family, flat)
    spec._save_lora_weights(str(tmp_path / "port"), extract_lora_state_dict(module), CONFIG)
    ref = np_load_file(str(tmp_path / "jax" / LORA_WEIGHTS_NAME))
    assert all(k.startswith("transformer.") and (".lora_A.weight" in k or ".lora_B.weight" in k) for k in ref)
    got = np_load_file(str(tmp_path / "port" / LORA_WEIGHTS_NAME))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    state, config = jax_load_lora_weights(str(tmp_path / "port"))
    assert config == CONFIG
    # The port reads JAX's adapter and its metadata.
    state, config = load_lora_weights(str(tmp_path / "jax"))
    assert config == CONFIG and sorted(state) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(state[key].numpy(), value)
    assert json.loads(safetensors_load_metadata(os.path.join(tmp_path, "jax", LORA_WEIGHTS_NAME))["lora_config"]) \
        == CONFIG


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_exported_model_equals_jax_export(family, tmp_path):
    jax_spec_cls, jax_cls, tiny = FAMILIES[family][:3]
    flat = _flat(family)
    jax_spec = jax_spec_cls(transformer_config=tiny)
    jax_handle = JaxModelHandle(jax_cls(**tiny, lora_rank=RANK, lora_alpha=ALPHA, dtype=jnp.float32),
                                unflatten_params(flat), dict(jax_spec.transformer_config))
    jax_spec._save_model(str(tmp_path / "jax"), jax_handle)
    spec, module = _port_module(family, flat)
    spec._save_model(str(tmp_path / "port"), ModelHandle(module, dict(spec.transformer_config)))
    ref = np_load_file(str(tmp_path / "jax" / MODEL_WEIGHTS_NAME))
    got = np_load_file(str(tmp_path / "port" / MODEL_WEIGHTS_NAME))
    assert sorted(got) == sorted(ref) and not any("lora" in key for key in ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    configs = [json.loads((tmp_path / side / "config.json").read_text()) for side in ("jax", "port")]
    assert configs[0] == configs[1] and configs[1]["_class_name"] == spec.transformer_class_name


def test_reloaded_adapter_reproduces_the_forward(tmp_path):
    spec, trained = _port_module("wan")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, param in extract_lora_state_dict(trained).items():
            param.copy_(0.3 * torch.randn(param.shape, generator=g))
    save_lora_weights(str(tmp_path), extract_lora_state_dict(trained), CONFIG)
    _, fresh = _port_module("wan")
    inputs = (torch.randn(1, 4, 2, 8, 8, generator=g), torch.randn(1, 16, 32, generator=g),
              torch.tensor([0.4]), torch.ones(1, 16, dtype=torch.int32))
    with torch.no_grad():
        before = fresh(*inputs)
        state, config = load_lora_weights(str(tmp_path / LORA_WEIGHTS_NAME))
        apply_lora_state_dict(fresh, state)
        reloaded, reference = fresh(*inputs), trained(*inputs)
    assert config == CONFIG and not torch.equal(before, reference)
    assert torch.equal(reloaded, reference)
    with pytest.raises(KeyError, match="not found"):
        apply_lora_state_dict(fresh, {"transformer.blocks.0.attn1.to_q.weight": torch.zeros(1)})
