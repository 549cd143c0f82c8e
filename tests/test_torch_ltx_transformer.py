"""LTX transformer parity: JAX `LTXVideoTransformer3DModel.apply` against the port.

Weights go across through `load_flax_params` (plain and scan-stacked trees,
LoRA included, with nonzero `lora_b` so the LoRA branch is exercised: it starts
at zero; every bias, norm scale and `scale_shift_table` gets noise too, so a
swapped or dropped leaf shows). Inputs are per-token (B, S) timesteps and a padded caption mask.
Both sides run fp32 at a tiny width; atol 1e-4 (tens of fp32 matmul and norm stages,
summed in another order). The port runs K1's plain version (fused RoPE,
kv_lens) while the JAX side takes its XLA path, so this also crosses the two
attention formulations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.ltx_video.transformer import LTXRotaryPosEmbed as JaxRope
from finetrainers_tpu.models.ltx_video.transformer import LTXVideoTransformer3DModel as JaxLTX
from finetrainers_tpu.models.ltx_video.transformer import pack_latents as jax_pack
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.ltx_video import (
    LTX_TRANSFORMER_CONFIG,
    LTXVideoTransformer3DModel,
    load_flax_params,
    pack_latents,
    unpack_latents,
)
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=8,
            cross_attention_dim=16, num_layers=2, caption_channels=32)
GRID = (3, 2, 4)  # latent (F, H, W) -> 24 tokens
ROPE_SCALE = (0.32, 32.0, 32.0)


def _jax_model(lora_rank, use_scan):
    module = JaxLTX(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1), dtype=jnp.float32,
                    use_scan=use_scan)
    params = drawn_params(module, jnp.zeros((1, 8, 4)), jnp.zeros((1, 16, 32)),
                          jnp.zeros((1,)), num_frames=2, height=2, width=2)
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    rng = np.random.RandomState(7)
    for key in flat:
        if key.endswith("lora_b"):  # starts at zero: make the LoRA branch count
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale", "scale_shift_table")):  # biases start at 0, norm scales at 1
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return module, flat


def _inputs():
    rng = np.random.RandomState(11)
    s = int(np.prod(GRID))
    tokens = rng.randn(2, s, 4).astype(np.float32)
    context = rng.randn(2, 16, 32).astype(np.float32)
    timesteps = rng.uniform(0, 1000, (2, s)).astype(np.float32)  # per-token
    mask = np.zeros((2, 16), np.int32)
    mask[0, :16] = 1
    mask[1, :5] = 1  # padded caption
    return tokens, context, timesteps, mask


@pytest.mark.parametrize("lora_rank,use_scan", [(0, False), (4, False), (4, True)],
                         ids=["dense", "lora", "lora_scan"])
def test_transformer_matches_jax(lora_rank, use_scan):
    module, flat = _jax_model(lora_rank, use_scan)
    if use_scan:
        assert any(".block." in k and k.startswith("transformer_blocks_scan") for k in flat)
    tokens, context, timesteps, mask = _inputs()
    params = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))
    apply = jax.jit(lambda p, *args: module.apply(
        {"params": p}, *args, num_frames=GRID[0], height=GRID[1], width=GRID[2],
        rope_interpolation_scale=ROPE_SCALE))
    ref = apply(params, *map(jnp.asarray, (tokens, context, timesteps, mask)))
    port = LTXVideoTransformer3DModel(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1),
                                      dtype=torch.float32)
    load_flax_params(port, flat)
    with torch.no_grad():
        out = port(torch.from_numpy(tokens), torch.from_numpy(context), torch.from_numpy(timesteps),
                   encoder_attention_mask=torch.from_numpy(mask), num_frames=GRID[0], height=GRID[1],
                   width=GRID[2], rope_interpolation_scale=ROPE_SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def test_rope_tables_match_jax():
    dim = 2 * 8 * 6 + 4  # identity slots: dim % 6 == 4
    ref_cos, ref_sin = JaxRope(dim=dim)(*GRID, ROPE_SCALE)
    port = LTXVideoTransformer3DModel(**{**TINY, "attention_head_dim": dim // 2}, dtype=torch.float32)
    cos, sin = port.rope(*GRID, ROPE_SCALE, torch.device("cpu"))
    np.testing.assert_allclose(cos.numpy(), np.asarray(ref_cos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(ref_sin), atol=1e-6, rtol=0)


def test_pack_unpack_match_jax():
    x = np.random.RandomState(0).randn(2, 4, 2, 4, 6).astype(np.float32)
    packed = pack_latents(torch.from_numpy(x), 2, 1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(jnp.asarray(x), 2, 1)))
    np.testing.assert_array_equal(unpack_latents(packed, 2, 4, 6, 2, 1).numpy(), x)


def test_full_width_parameter_count():
    """The published LTX config has 1,923,385,472 parameters (jax.eval_shape on
    the JAX model); the port at the same config must hold the same count."""
    with torch.device("meta"):
        model = LTXVideoTransformer3DModel(**LTX_TRANSFORMER_CONFIG)
    assert sum(p.numel() for p in model.parameters()) == 1_923_385_472


def test_seeded_init_is_reproducible_and_keeps_lora_b_zero():
    def build():
        model = LTXVideoTransformer3DModel(**TINY, lora_rank=4, dtype=torch.float32)
        return init_parameters_(model, torch.Generator().manual_seed(3))

    a, b = build(), build()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("lora_B.weight"):
            assert not pa.any()
