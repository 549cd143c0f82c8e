"""Flux transformer parity: JAX `FluxTransformer2DModel.apply` against the port.

A tiny model (2 dual and 2 single blocks, 2 heads of 64 with RoPE axes (16,
24, 24), so the same config runs on the card's kernels), weights from JAX's
init carried across by `load_flax_params` (per-block and scan-stacked trees;
with LoRA, nonzero `lora_b`; every bias and norm scale moved off its init, so
a swapped or dropped leaf shows). Inputs: (2, 16, 4, 6) latents packed into
2 x 3 = 6 image tokens, 8 text tokens, per-sample timesteps and guidance.
Both sides run fp32 under `auto` (the port's K1 plain version with the fused
rotation, JAX its own path). atol 1e-4: tens of fp32 matmul and norm stages
summed in another order (measured ~5e-6). The sinusoidal timestep and
guidance embeddings are the one stage where the packages' fp32 `exp` differ
by an ulp: at guidance 3500 one ulp of the angle is 2.4e-4, so the two
embeddings differ by up to ~1.1e-4 and the LoRA model's output by ~1e-4. The
transformer comparison therefore hands the port JAX's embedding of the same
timesteps, and `test_timestep_embedding_within_an_ulp_of_the_angle` holds the
port's own embedding to JAX's within two ulps of the largest angle. The
packing, the image ids and the RoPE angles are compared for exact equality;
the RoPE tables within one ulp of 1.0 (the packages' fp32 cos and sin differ
by an ulp in ~4% of the entries at the same angle); the full-width parameter
count under the meta device against JAX's `jax.eval_shape`; the offline
text encoder's pooled output byte for byte.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.flux import FLUX_TRANSFORMER_CONFIG as JAX_FLUX_CONFIG
from finetrainers_tpu.models.flux.transformer import FluxTransformer2DModel as JaxFlux
from finetrainers_tpu.models.flux.transformer import _rope_tables as jax_rope_tables
from finetrainers_tpu.models.flux.transformer import flux_rope_freqs as jax_flux_rope_freqs
from finetrainers_tpu.models.flux.transformer import pack_flux_latents as jax_pack
from finetrainers_tpu.models.flux.transformer import prepare_latent_image_ids as jax_image_ids
from finetrainers_tpu.models.flux.transformer import unpack_flux_latents as jax_unpack
from finetrainers_tpu.models.layers import sinusoidal_timestep_embedding as jax_timestep_embedding
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu_torch.models.flux import (
    FLUX_TRANSFORMER_CONFIG,
    FluxTransformer2DModel,
    flux_rope_angles,
    flux_rope_freqs,
    load_flax_params,
    pack_flux_latents,
    prepare_latent_image_ids,
    rope_tables,
    unpack_flux_latents,
)
from finetrainers_tpu_torch.models.flux import transformer as flux_transformer
from finetrainers_tpu_torch.models.layers import init_parameters_, sinusoidal_timestep_embedding
from finetrainers_tpu_torch.processors import HashEncoder
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=16, num_layers=2, num_single_layers=2, num_attention_heads=2, attention_head_dim=64,
            pooled_projection_dim=24, joint_attention_dim=32, guidance_embeds=True, axes_dims_rope=(16, 24, 24))
LATENT = (2, 4, 4, 6)  # (B, C, H, W): 2 x 3 packed tokens of 16 channels
TEXT_LEN = 8
ATOL = 1e-4


def _example_inputs(cfg):
    return (jnp.zeros((1, 4, cfg["in_channels"])), jnp.zeros((1, 8, cfg["joint_attention_dim"])),
            jnp.zeros((1, cfg["pooled_projection_dim"])), jnp.zeros((1,)), jnp.zeros((4, 3)), jnp.zeros((8, 3)))


def jax_flux_params(module, seed=7):
    """JAX's init (`drawn_params`), flattened, with nonzero `lora_b` and every bias and
    norm scale moved off its init."""
    params = drawn_params(module, *_example_inputs(TINY))
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    rng = np.random.RandomState(seed)
    for key in flat:
        if key.endswith("lora_b"):  # starts at zero: make the LoRA branch count
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale")):  # biases start at 0, norm scales at 1
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return flat


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _inputs():
    """(packed latents, text states, pooled, timesteps, image ids, text ids, guidance), numpy."""
    rng = np.random.RandomState(11)
    b, c, h, w = LATENT
    latents = rng.randn(*LATENT).astype(np.float32)
    packed = np.asarray(jax_pack(jnp.asarray(latents)))
    text = rng.randn(b, TEXT_LEN, TINY["joint_attention_dim"]).astype(np.float32)
    pooled = rng.randn(b, TINY["pooled_projection_dim"]).astype(np.float32)
    timesteps = np.asarray([999.0, 312.5], np.float32)
    guidance = np.asarray([3500.0, 1000.0], np.float32)
    img_ids = np.asarray(jax_image_ids(h, w), np.float32)
    txt_ids = np.zeros((TEXT_LEN, 3), np.float32)
    return packed, text, pooled, timesteps, img_ids, txt_ids, guidance


@functools.lru_cache(maxsize=None)
def _apply(lora_rank, use_scan):
    module = JaxFlux(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1), dtype=jnp.float32,
                     use_scan=use_scan)
    flat = jax_flux_params(module)
    apply = jax.jit(lambda p, *args: module.apply({"params": p}, *args[:6], guidance=args[6]))
    return flat, np.asarray(apply(unflatten(flat), *map(jnp.asarray, _inputs())))


def jax_embedding(monkeypatch, module=flux_transformer):
    """Give the port's `module` JAX's sinusoidal embedding of the same timesteps."""
    monkeypatch.setattr(module, "sinusoidal_timestep_embedding", lambda t, dim: torch.from_numpy(
        np.array(jax_timestep_embedding(jnp.asarray(t.cpu().numpy()), dim))).to(t.device))


def test_timestep_embedding_within_an_ulp_of_the_angle():
    """Flux's timesteps and guidance (sigma * 1000 and 3.5 * 1000): the port's
    fp32 embedding within two ulps of the largest angle of JAX's."""
    t = np.asarray([999.0, 312.5, 3500.0, 1000.0, 0.0], np.float32)
    ref = np.asarray(jax_timestep_embedding(jnp.asarray(t), 256))
    got = sinusoidal_timestep_embedding(torch.from_numpy(t), 256).numpy()
    np.testing.assert_allclose(got, ref, atol=2 * float(np.spacing(np.float32(3500.0))), rtol=0)


@pytest.mark.parametrize("lora_rank,use_scan", [(0, False), (4, False), (4, True)],
                         ids=["base", "lora", "lora_scan"])
def test_transformer_matches_jax(lora_rank, use_scan, monkeypatch):
    jax_embedding(monkeypatch)
    flat, ref = _apply(lora_rank, use_scan)
    if use_scan:
        assert any(k.startswith("single_transformer_blocks_scan.block") for k in flat)
    port = FluxTransformer2DModel(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1),
                                  dtype=torch.float32)
    load_flax_params(port, flat)
    with torch.no_grad():
        packed, text, pooled, timesteps, img_ids, txt_ids, guidance = (torch.from_numpy(np.array(x))
                                                                        for x in _inputs())
        out = port(packed, text, pooled, timesteps, img_ids, txt_ids, guidance=guidance)
    assert out.dtype == torch.float32 and out.shape == (2, 6, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_guidance_defaults_to_3_5():
    """Without `guidance` the embedder takes 3.5 * 1000, as in JAX (:233)."""
    flat, _ = _apply(0, False)
    port = load_flax_params(FluxTransformer2DModel(**TINY, dtype=torch.float32), flat)
    packed, text, pooled, timesteps, img_ids, txt_ids, _ = (torch.from_numpy(np.array(x)) for x in _inputs())
    with torch.no_grad():
        default = port(packed, text, pooled, timesteps, img_ids, txt_ids)
        explicit = port(packed, text, pooled, timesteps, img_ids, txt_ids, guidance=torch.full((2,), 3500.0))
    assert torch.equal(default, explicit)


@pytest.mark.parametrize("height,width,text_len,axes", [
    (4, 6, 8, (16, 24, 24)), (90, 160, 512, (16, 56, 56)), (128, 128, 512, (16, 56, 56))],
    ids=["tiny", "flux_train_1280x720", "flux_serve_1024"])
def test_rope_tables_and_ids_match_jax(height, width, text_len, axes):
    """The ids and the rotary angles of the joint sequence bit-equal to JAX's;
    the repeat-2 (S, 128) tables, text rows first and the identity there,
    within one ulp of 1.0 of JAX's (both fp32)."""
    ids_ref = np.asarray(jax_image_ids(height, width))
    ids = prepare_latent_image_ids(height, width)
    assert ids.dtype == torch.float32 and ids.shape == ((height // 2) * (width // 2), 3)
    np.testing.assert_array_equal(ids.numpy(), ids_ref)
    joint = np.concatenate([np.zeros((text_len, 3), np.float32), ids_ref])
    jids = jnp.asarray(joint)
    # JAX's angles, the lines of `flux_rope_freqs` (transformer.py:37-41) before the cos and sin.
    ref_angles = jnp.concatenate([jids[:, i:i + 1] * (1.0 / (10000.0 ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d)))
                                  [None, :] for i, d in enumerate(axes)], axis=-1)
    np.testing.assert_array_equal(flux_rope_angles(torch.from_numpy(joint), axes).numpy(), np.asarray(ref_angles))
    ref = jax_rope_tables(*jax_flux_rope_freqs(jids, axes))
    got = rope_tables(*flux_rope_freqs(torch.from_numpy(joint), axes))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (joint.shape[0], sum(axes))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=float(np.spacing(np.float32(1.0))), rtol=0)
    assert torch.equal(got[0][:text_len], torch.ones(text_len, sum(axes)))
    assert not got[1][:text_len].any()


def test_pack_and_unpack_match_jax_exactly():
    x = np.random.RandomState(3).randn(2, 16, 10, 6).astype(np.float32)
    packed = pack_flux_latents(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(jnp.asarray(x))))
    assert packed.shape == (2, 15, 64)
    np.testing.assert_array_equal(unpack_flux_latents(packed, 10, 6).numpy(),
                                  np.asarray(jax_unpack(jnp.asarray(packed.numpy()), 10, 6)))
    assert torch.equal(unpack_flux_latents(packed, 10, 6), torch.from_numpy(x))


def _jax_param_count(**kw):
    module = JaxFlux(**JAX_FLUX_CONFIG, **kw, use_scan=True)
    cfg = JAX_FLUX_CONFIG
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *_example_inputs(cfg)))["params"]
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_full_width_parameter_count_equals_jax():
    """FLUX.1-dev at full width (19 dual, 38 single blocks, 24 heads x 128)
    built under the meta device holds JAX's count under `jax.eval_shape`, and
    at LoRA rank 32 as many LoRA parameters more as JAX's."""
    assert FLUX_TRANSFORMER_CONFIG == JAX_FLUX_CONFIG
    with torch.device("meta"):
        model = FluxTransformer2DModel(**FLUX_TRANSFORMER_CONFIG)
        lora = FluxTransformer2DModel(**FLUX_TRANSFORMER_CONFIG, lora_rank=32)
    base = sum(p.numel() for p in model.parameters())
    assert base == _jax_param_count() == 11_901_408_320
    assert sum(p.numel() for p in lora.parameters()) == _jax_param_count(lora_rank=32)
    assert len(model.transformer_blocks) == 19 and len(model.single_transformer_blocks) == 38


def test_seeded_init_is_reproducible_and_keeps_lora_b_zero():
    def build():
        return init_parameters_(FluxTransformer2DModel(**TINY, lora_rank=4, dtype=torch.float32),
                                torch.Generator().manual_seed(3))

    a, b = build(), build()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("lora_B.weight"):
            assert not pa.any()


@pytest.mark.parametrize("pooled_dim", [None, 768])
def test_hash_encoder_pooled_bytes_equal_jax(pooled_dim):
    captions = ["a trtcrd of a lighthouse on a cliff at night, tarot style", "", "a fox"]
    ref = JaxHashEncoder(hidden_size=32, max_length=16, pooled_dim=pooled_dim).encode_pooled(captions)
    got = HashEncoder(hidden_size=32, max_length=16, pooled_dim=pooled_dim).encode_pooled(captions)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (3, pooled_dim or 32)
    assert got.tobytes() == ref.tobytes()
