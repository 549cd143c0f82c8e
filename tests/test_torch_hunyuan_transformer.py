"""HunyuanVideo transformer parity: JAX `HunyuanVideoTransformer3DModel.apply` against the port.

A tiny model (2 dual, 2 single and 2 refiner blocks, 2 heads of 64 with RoPE
axes (16, 24, 24), so the same config runs on the card's kernels), weights
from JAX's init carried across by `load_flax_params` (per-block and
scan-stacked trees; with LoRA, nonzero `lora_b`; every bias and norm scale
moved off its init, so a swapped or dropped leaf shows). Inputs: a (2, 4, 3,
4, 6) latent -> 3 frames x 2 x 3 = 18 video tokens after the (1, 2, 2) patch,
8 text tokens, per-sample timesteps and guidance; the text mask with valid
lengths [5, 3] (kv_lens < L), [8, 8] (= L), as (B,) lengths, and none (each
with LoRA; the base model at kv_lens < L). Both
sides run fp32 under `auto` (the port's K1 plain version with the fused
rotation and kv_lens, JAX its own path). atol 1e-4: tens of fp32 matmul and
norm stages summed in another order. The sinusoidal timestep and guidance
embeddings are the one stage where the packages' fp32 `exp` differ by an ulp
(test_torch_flux_transformer.py holds that stage alone), so the port is
handed JAX's embedding of the same timesteps. The patchify, its inverse, the
video ids and the RoPE angles are compared for exact equality, the tables
within one ulp of 1.0 (the packages' fp32 cos and sin differ by an ulp at the
same angle); the full-width parameter count under the meta device against
JAX's `jax.eval_shape`. Two JAX behaviours are pinned on both sides: the
padded text slots are keys of the joint attention (ROADMAP.md section 3,
finding 15), and the refiner's padded query rows are computed, not zeroed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.flux.transformer import _rope_tables as jax_rope_tables
from finetrainers_tpu.models.flux.transformer import flux_rope_freqs as jax_flux_rope_freqs
from finetrainers_tpu.models.hunyuan_video import HUNYUAN_VIDEO_CONFIG as JAX_HUNYUAN_CONFIG
from finetrainers_tpu.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel as JaxHunyuan
from finetrainers_tpu.models.hunyuan_video.transformer import TokenRefinerBlock as JaxRefinerBlock
from finetrainers_tpu.models.layers import sinusoidal_timestep_embedding as jax_timestep_embedding
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu_torch.models.flux import flux_rope_angles, flux_rope_freqs, rope_tables
from finetrainers_tpu_torch.models.hunyuan_video import (
    HUNYUAN_VIDEO_CONFIG,
    HunyuanVideoTransformer3DModel,
    kv_lens_from_mask,
    load_flax_params,
    patchify,
    unpatchify,
    video_ids,
)
from finetrainers_tpu_torch.models.hunyuan_video import transformer as hunyuan_transformer
from finetrainers_tpu_torch.models.hunyuan_video.transformer import TokenRefinerBlock
from finetrainers_tpu_torch.models.layers import init_parameters_
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=64, num_layers=2,
            num_single_layers=2, num_refiner_layers=2, text_embed_dim=32, pooled_projection_dim=24,
            guidance_embeds=True, rope_axes_dim=(16, 24, 24))
LATENT = (2, 4, 3, 4, 6)  # (B, C, F, H, W): 3 x 2 x 3 patches
TEXT_LEN = 8
ATOL = 1e-4
MASKS = {"kv_lens_below_L": [5, 3], "kv_lens_equal_L": [8, 8], "lengths_1d": [5, 3], "no_mask": None}


def _example_inputs(cfg):
    return (jnp.zeros((1, cfg["in_channels"], 1, 4, 4)), jnp.zeros((1, 8, cfg["text_embed_dim"])), jnp.zeros((1,)),
            jnp.zeros((1, cfg["pooled_projection_dim"])))


def jax_hunyuan_params(module, seed=7):
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


def jax_embedding(monkeypatch, module=hunyuan_transformer):
    """Give the port's `module` JAX's sinusoidal embedding of the same timesteps."""
    monkeypatch.setattr(module, "sinusoidal_timestep_embedding", lambda t, dim: torch.from_numpy(
        np.array(jax_timestep_embedding(jnp.asarray(t.cpu().numpy()), dim))).to(t.device))


def mask_input(name):
    """The text mask of case `name`: (B, L) int32 prefix masks, (B,) lengths, or None."""
    lens = MASKS[name]
    if lens is None:
        return None
    if name == "lengths_1d":
        return np.asarray(lens, np.int32)
    return (np.arange(TEXT_LEN)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)


def _inputs(seed=11):
    """(latents, text states, timesteps, pooled, guidance), numpy."""
    rng = np.random.RandomState(seed)
    latents = rng.randn(*LATENT).astype(np.float32)
    text = rng.randn(LATENT[0], TEXT_LEN, TINY["text_embed_dim"]).astype(np.float32)
    timesteps = np.asarray([999.0, 312.5], np.float32)
    pooled = rng.randn(LATENT[0], TINY["pooled_projection_dim"]).astype(np.float32)
    guidance = np.asarray([6000.0, 1000.0], np.float32)
    return latents, text, timesteps, pooled, guidance


@functools.lru_cache(maxsize=None)
def _jax_model(lora_rank):
    module = JaxHunyuan(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1), dtype=jnp.float32,
                        use_scan=False)
    flat = jax_hunyuan_params(module)
    apply = jax.jit(lambda p, x, ehs, t, pooled, mask, g: module.apply(
        {"params": p}, x, ehs, t, pooled, encoder_attention_mask=mask, guidance=g))
    return flat, apply


def _jax_apply(lora_rank, mask, text=None):
    flat, apply = _jax_model(lora_rank)
    latents, text_in, timesteps, pooled, guidance = _inputs()
    text = text_in if text is None else text
    return np.asarray(apply(unflatten(flat), jnp.asarray(latents), jnp.asarray(text), jnp.asarray(timesteps),
                            jnp.asarray(pooled), None if mask is None else jnp.asarray(mask), jnp.asarray(guidance)))


def port_model(lora_rank, stacked=None):
    flat = _jax_model(lora_rank)[0] if stacked is None else stacked
    model = HunyuanVideoTransformer3DModel(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1),
                                           dtype=torch.float32)
    return load_flax_params(model, flat)


def _port_apply(model, mask, text=None):
    latents, text_in, timesteps, pooled, guidance = _inputs()
    text = text_in if text is None else text
    with torch.no_grad():
        return model(torch.from_numpy(latents), torch.from_numpy(text), torch.from_numpy(timesteps),
                     torch.from_numpy(pooled), encoder_attention_mask=None if mask is None else torch.from_numpy(mask),
                     guidance=torch.from_numpy(guidance)).numpy()


@pytest.mark.parametrize("lora_rank,mask_name", [(4, name) for name in sorted(MASKS)] + [(0, "kv_lens_below_L")],
                         ids=lambda v: {4: "lora", 0: "base"}.get(v, v))
def test_transformer_matches_jax(lora_rank, mask_name, monkeypatch):
    jax_embedding(monkeypatch)
    mask = mask_input(mask_name)
    ref = _jax_apply(lora_rank, mask)
    out = _port_apply(port_model(lora_rank), mask)
    assert out.dtype == np.float32 and out.shape == LATENT
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_scan_stacked_tree_loads_as_the_per_block_one():
    """JAX's scan-stacked layout (`<list>_scan.block.<leaf>` with a leading
    layer axis; names and shapes from `jax.eval_shape` of the scanned model)
    built from the per-block tree loads into the same port model."""
    flat, _ = _jax_model(4)
    module = JaxHunyuan(**TINY, lora_rank=4, lora_alpha=8.0, dtype=jnp.float32, use_scan=True)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *_example_inputs(TINY)))
    shapes = flatten_params(shapes["params"])
    stacked = {}
    for key in shapes:
        if "_scan.block." in key:
            name, rest = key.split("_scan.block.")
            depth = TINY["num_layers" if name == "transformer_blocks" else "num_single_layers"]
            stacked[key] = np.stack([flat[f"{name}_{i}.{rest}"] for i in range(depth)])
        else:
            stacked[key] = flat[key]
        assert stacked[key].shape == tuple(shapes[key].shape), key
    assert any(k.startswith("single_transformer_blocks_scan.block") for k in stacked)
    per_block, scanned = port_model(4).state_dict(), port_model(4, stacked=stacked).state_dict()
    assert sorted(per_block) == sorted(scanned)
    assert all(torch.equal(per_block[k], scanned[k]) for k in per_block)


def test_guidance_defaults_to_6():
    """Without `guidance` the embedder takes 6.0 * 1000, as in JAX (:122)."""
    model = port_model(0)
    latents, text, timesteps, pooled, _ = (torch.from_numpy(x) for x in _inputs())
    with torch.no_grad():
        default = model(latents, text, timesteps, pooled)
        explicit = model(latents, text, timesteps, pooled, guidance=torch.full((2,), 6000.0))
    assert torch.equal(default, explicit)


def test_padded_text_slots_are_joint_attention_keys_as_in_jax(monkeypatch):
    """A JAX bug the port reproduces (ROADMAP.md section 3, finding 15): the
    60 blocks pass no mask, so the text states past the mask's lengths, after
    the refiner, are keys of the joint attention and move the video output.
    Changing them moves both packages' outputs alike; diffusers masks them."""
    jax_embedding(monkeypatch)
    mask = mask_input("kv_lens_below_L")
    text = _inputs()[1].copy()
    text[0, 5:] += 3.0  # past kv_lens[0] = 5
    text[1, 3:] -= 3.0  # past kv_lens[1] = 3
    model = port_model(0)
    base, moved = _port_apply(model, mask), _port_apply(model, mask, text)
    assert np.abs(moved - base).max() > 1e-3
    np.testing.assert_allclose(moved, _jax_apply(0, mask, text=text), atol=ATOL, rtol=0)


def test_refiner_block_keeps_padded_query_rows_as_jax(monkeypatch):
    """The refiner's attention takes `kv_lens` for its keys only: the padded
    query rows attend to the valid keys and go on to the joint blocks, in
    both packages (the rows past kv_lens are nonzero and equal)."""
    dim, heads = 128, 2
    jax_block = JaxRefinerBlock(dim, heads, lora_rank=4, lora_alpha=8.0, dtype=jnp.float32)
    rng = np.random.RandomState(5)
    x = rng.randn(2, TEXT_LEN, dim).astype(np.float32)
    cond = rng.randn(2, dim).astype(np.float32)
    lens = np.asarray([5, 3], np.int32)
    params = drawn_params(jax_block, jnp.asarray(x), jnp.asarray(cond),
                          jnp.asarray(lens), seed=1)
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    for key in flat:  # at width 128 a B factor of scale 0.5 would give outputs of ~50: keep them ~1
        if key.endswith("lora_b"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.05).astype(np.float32)
        elif key.endswith(("bias", "scale")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    ref = np.asarray(jax.jit(jax_block.apply)({"params": unflatten(flat)}, jnp.asarray(x), jnp.asarray(cond),
                                              jnp.asarray(lens)))
    block = TokenRefinerBlock(dim, heads, lora_rank=4, lora_alpha=8.0, dtype=torch.float32)
    load_flax_params(block, flat)
    with torch.no_grad():
        out = block(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(lens)).numpy()
    assert np.abs(ref).max() < 20
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert np.abs(out[0, 5:]).min() > 0 and np.abs(out[1, 3:]).min() > 0


def test_kv_lens_from_a_2d_or_1d_mask():
    mask = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0]], dtype=torch.int64)
    assert torch.equal(kv_lens_from_mask(mask), torch.tensor([3, 1], dtype=torch.int32))
    assert torch.equal(kv_lens_from_mask(torch.tensor([4, 0])), torch.tensor([4, 0], dtype=torch.int32))
    assert kv_lens_from_mask(None) is None


@pytest.mark.parametrize("shape", [(2, 4, 3, 4, 6), (1, 16, 13, 60, 96)], ids=["tiny", "hunyuan_49x480x768"])
def test_patchify_and_unpatchify_match_jax_exactly(shape):
    """The (1, 2, 2) patch in (c, pt, p, p) order and its inverse, against
    JAX's lines (transformer.py:113-115, :200-201); the full-width one is the
    example's 49x480x768 bucket, 18,720 tokens."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    b, c, f, h, w = shape
    ref = jnp.asarray(x).reshape(b, c, f, 1, h // 2, 2, w // 2, 2).transpose(0, 2, 4, 6, 1, 3, 5, 7)
    ref = ref.reshape(b, f * (h // 2) * (w // 2), c * 4)
    got = patchify(torch.from_numpy(x), 2, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = ref.reshape(b, f, h // 2, w // 2, c, 1, 2, 2).transpose(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, c, f, h, w)
    np.testing.assert_array_equal(unpatchify(got, (f, h, w), c, 2, 1).numpy(), np.asarray(back))
    assert torch.equal(unpatchify(got, (f, h, w), c, 2, 1), torch.from_numpy(x))


@pytest.mark.parametrize("grid,text_len,axes", [((3, 2, 3), 8, (16, 24, 24)), ((13, 30, 48), 256, (16, 56, 56))],
                         ids=["tiny", "hunyuan_49x480x768"])
def test_ids_and_rope_tables_match_jax(grid, text_len, axes):
    """The (frame, row, col) ids bit-equal to JAX's (:158-163), the joint
    angles bit-equal, the repeat-2 (S, 128) tables, text rows first and the
    identity there, within one ulp of 1.0 (both fp32). At 49x480x768 the frame
    axis runs 0..12, unlike Flux's, which is all zero."""
    pf, ph, pw = grid
    ids = video_ids(pf, ph, pw)
    ref_ids = jnp.stack([jnp.repeat(jnp.arange(pf), ph * pw), jnp.tile(jnp.repeat(jnp.arange(ph), pw), pf),
                         jnp.tile(jnp.arange(pw), pf * ph)], axis=-1).astype(jnp.float32)
    assert ids.dtype == torch.float32 and ids.shape == (pf * ph * pw, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert ids[:, 0].max() == pf - 1
    joint = jnp.concatenate([jnp.zeros((text_len, 3)), ref_ids], axis=0)
    ref_angles = jnp.concatenate([joint[:, i:i + 1] * (1.0 / (10000.0 ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d)))
                                  [None, :] for i, d in enumerate(axes)], axis=-1)
    joint_t = torch.from_numpy(np.array(joint))
    np.testing.assert_array_equal(flux_rope_angles(joint_t, axes).numpy(), np.asarray(ref_angles))
    got = rope_tables(*flux_rope_freqs(joint_t, axes))
    for g, r in zip(got, jax_rope_tables(*jax_flux_rope_freqs(joint, axes))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=float(np.spacing(np.float32(1.0))), rtol=0)
    assert torch.equal(got[0][:text_len], torch.ones(text_len, sum(axes)))
    assert not got[1][:text_len].any()


def _jax_param_count(**kw):
    module = JaxHunyuan(**JAX_HUNYUAN_CONFIG, **kw, use_scan=True)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *_example_inputs(JAX_HUNYUAN_CONFIG)))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))


def test_full_width_parameter_count_equals_jax():
    """HunyuanVideo at full width (20 dual, 40 single, 2 refiner blocks, 24
    heads x 128) built under the meta device holds JAX's count under
    `jax.eval_shape`, 12,817,866,816, and at LoRA rank 32 141,164,544 more."""
    assert HUNYUAN_VIDEO_CONFIG == JAX_HUNYUAN_CONFIG
    with torch.device("meta"):
        model = HunyuanVideoTransformer3DModel(**HUNYUAN_VIDEO_CONFIG)
        lora = HunyuanVideoTransformer3DModel(**HUNYUAN_VIDEO_CONFIG, lora_rank=32)
    base = sum(p.numel() for p in model.parameters())
    assert base == _jax_param_count() == 12_817_866_816
    assert sum(p.numel() for p in lora.parameters()) - base == _jax_param_count(lora_rank=32) - base == 141_164_544
    assert len(model.transformer_blocks) == 20 and len(model.single_transformer_blocks) == 40


def test_seeded_init_is_reproducible_and_keeps_lora_b_zero():
    def build():
        return init_parameters_(HunyuanVideoTransformer3DModel(**TINY, lora_rank=4, dtype=torch.float32),
                                torch.Generator().manual_seed(3))

    a, b = build(), build()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("lora_B.weight"):
            assert not pa.any()
