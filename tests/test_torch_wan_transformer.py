"""Wan 2.1 transformer parity: JAX `WanTransformer3DModel.apply` against the port.

A tiny model (2 blocks, 2 heads of 64, so the sage path runs at a head dim K6
takes on the card), weights from JAX's init carried across by
`load_flax_params` (per-block and scan-stacked trees; with LoRA, nonzero
`lora_b`; every bias, norm scale and `scale_shift_table` moved off its init,
so a swapped or dropped leaf shows). Inputs: a (2, 4, 3, 4, 6) latent ->
3*2*3 = 18 tokens, a padded text mask, per-sample timesteps. Both sides run
fp32, under the same attention provider: under `auto` the port runs K1's
plain version (fused RoPE, kv_lens) and JAX its own path; under `sage` both
quantize q and k to int8 (JAX in the Pallas kernel, interpret mode) and get
the same codes. atol 1e-4 for both: tens of fp32 matmul and norm stages,
summed in another order (measured ~2e-6; one flipped int8 code would show as
~1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.wan.transformer import WanTransformer3DModel as JaxWan
from finetrainers_tpu.models.wan.transformer import wan_rope_freqs as jax_wan_rope_freqs
from finetrainers_tpu.ops import attention_provider as jax_attention_provider
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.wan import (
    WAN_I2V_14B_CONFIG,
    WAN_T2V_1_3B_CONFIG,
    WanTransformer3DModel,
    load_flax_params,
    wan_rope_freqs,
)
from finetrainers_tpu_torch.ops import attention_provider
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=2, ffn_dim=48, text_dim=32, freq_dim=16)
LATENT = (2, 4, 3, 4, 6)
ATOL = 1e-4


def _jax_model(lora_rank, use_scan):
    module = JaxWan(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1), dtype=jnp.float32,
                    use_scan=use_scan)
    params = drawn_params(module, jnp.zeros((1, 4, 1, 4, 4)), jnp.zeros((1, 8, 32)),
                          jnp.zeros((1,)))
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    rng = np.random.RandomState(7)
    for key in flat:
        if key.endswith("lora_b"):  # starts at zero: make the LoRA branch count
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale", "scale_shift_table")):  # biases start at 0, norm scales at 1
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return module, flat


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _inputs():
    rng = np.random.RandomState(11)
    latents = rng.randn(*LATENT).astype(np.float32)
    context = rng.randn(2, 16, 32).astype(np.float32)
    timesteps = np.asarray([999.0, 312.5], np.float32)
    mask = np.zeros((2, 16), np.int32)
    mask[0, :16] = 1
    mask[1, :5] = 1  # padded text
    return latents, context, timesteps, mask


@pytest.mark.parametrize("provider,lora_rank,use_scan", [
    ("auto", 0, False), ("auto", 4, True), ("sage", 0, False), ("sage", 4, True),
], ids=["auto", "auto_lora_scan", "sage", "sage_lora_scan"])
def test_transformer_matches_jax(provider, lora_rank, use_scan):
    module, flat = _jax_model(lora_rank, use_scan)
    if use_scan:
        assert any(k.startswith("blocks_scan.block") for k in flat)
    latents, context, timesteps, mask = _inputs()
    params = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))
    apply = jax.jit(lambda p, *args: module.apply({"params": p}, *args[:3], encoder_attention_mask=args[3]))
    with jax_attention_provider(provider):
        ref = apply(params, *map(jnp.asarray, (latents, context, timesteps, mask)))
    port = WanTransformer3DModel(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1),
                                 dtype=torch.float32)
    load_flax_params(port, flat)
    with torch.no_grad(), attention_provider(provider):
        out = port(torch.from_numpy(latents), torch.from_numpy(context), torch.from_numpy(timesteps),
                   encoder_attention_mask=torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == LATENT
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_dim,grid", [(128, (13, 32, 48)), (16, (3, 2, 3))], ids=["wan_1_3b", "tiny"])
def test_rope_tables_match_jax(head_dim, grid):
    """fp32 arithmetic on both sides; 1 ulp of cos/sin at most."""
    ref_cos, ref_sin = jax_wan_rope_freqs(head_dim, *grid)
    cos, sin = wan_rope_freqs(head_dim, *grid)
    assert cos.shape == (int(np.prod(grid)), head_dim // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(ref_cos), atol=1.2e-7, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(ref_sin), atol=1.2e-7, rtol=0)


def test_full_width_parameter_count():
    """WAN_T2V_1_3B_CONFIG has 1,418,996,800 parameters (jax.eval_shape on the
    JAX model); the port at the same config must hold the same count."""
    with torch.device("meta"):
        model = WanTransformer3DModel(**WAN_T2V_1_3B_CONFIG)
    assert sum(p.numel() for p in model.parameters()) == 1_418_996_800
    assert len(model.blocks) == 30


def test_image_to_video_is_not_ported():
    """Image-to-video is ported (the name is kept from when it raised):
    WAN_I2V_14B_CONFIG builds at full width under the meta device with
    16,419,458,624 parameters (jax.eval_shape on the JAX model), 179,568,640
    more at LoRA rank 32, and every block's cross-attention carries the
    image-KV projections."""
    assert WAN_I2V_14B_CONFIG["image_dim"] == 1280
    with torch.device("meta"):
        model = WanTransformer3DModel(**WAN_I2V_14B_CONFIG)
        lora = WanTransformer3DModel(**WAN_I2V_14B_CONFIG, lora_rank=32)
    assert sum(p.numel() for p in model.parameters()) == 16_419_458_624
    assert sum(p.numel() for n, p in lora.named_parameters() if "lora_" in n) == 179_568_640
    assert len(model.blocks) == 40 and all(block.attn2.has_image_kv for block in model.blocks)
    assert model.patch_embedding.in_features == 36 * 4


def test_seeded_init_is_reproducible_and_keeps_lora_b_zero():
    def build():
        model = WanTransformer3DModel(**TINY, lora_rank=4, dtype=torch.float32)
        return init_parameters_(model, torch.Generator().manual_seed(3))

    a, b = build(), build()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("lora_B.weight"):
            assert not pa.any()
