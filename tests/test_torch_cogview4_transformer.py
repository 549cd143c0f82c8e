"""CogView4 transformer parity: JAX `CogView4Transformer2DModel.apply` against the port.

A tiny model (2 blocks, 2 heads of 64, time width 32, 16-wide condition
embeddings), weights from JAX's init carried across by `load_flax_params`
(per-block and scan-stacked trees; with LoRA, nonzero `lora_b`; every bias
and norm scale moved off its init, so a swapped or dropped leaf shows).
Inputs: (2, 4, 8, 12) latents in 4 x 6 patches of 2 x 2, 8 text slots, per
sample timesteps, sizes and crops (and, once, no sizes: zeros stand in, JAX
:140). Both sides run fp32 under `auto`; atol 1e-4 (tens of fp32 matmul and
norm stages summed in another order). The sinusoidal embeddings are handed
over from JAX, as for Flux (the packages' fp32 `exp` differ by an ulp: at a
size of 1024 one ulp of the angle is 6e-5); the port's own are held to
JAX's within two ulps of the largest angle. The RoPE tables of the joint
sequence (identity text rows) are held to JAX's within one ulp of 1.0 at
the tiny and the full-width 1024x1024 shapes; the patchify exact; the
full-width parameter counts under the meta device against JAX's
`jax.eval_shape`, the control-widened one too; the LoRA and full-rank
exports against the JAX spec's files, key for key and value for value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.cogview4 import COGVIEW4_TRANSFORMER_CONFIG as JAX_CONFIG
from finetrainers_tpu.models.cogview4.transformer import CogView4Transformer2DModel as JaxCogView4
from finetrainers_tpu.models.layers import axial_rope_freqs as jax_axial_rope_freqs
from finetrainers_tpu.models.layers import sinusoidal_timestep_embedding as jax_timestep_embedding
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu_torch.models.cogview4 import (
    COGVIEW4_TRANSFORMER_CONFIG,
    CogView4Transformer2DModel,
    cogview4_rope_tables,
    load_flax_params,
    patchify,
    unpatchify,
)
from finetrainers_tpu_torch.models.cogview4 import transformer as cogview4_transformer
from finetrainers_tpu_torch.models.layers import init_parameters_, sinusoidal_timestep_embedding
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, patch_size=2, num_attention_heads=2, attention_head_dim=64,
            num_layers=2, text_embed_dim=32, time_embed_dim=32, condition_dim=16)
LATENT = (2, 4, 8, 12)
TEXT_LEN = 8
ATOL = 1e-4


def _example_inputs(cfg):
    p = cfg["patch_size"]
    return (jnp.zeros((1, cfg["in_channels"], 2 * p, 2 * p)), jnp.zeros((1, 8, cfg["text_embed_dim"])),
            jnp.zeros((1,)))


def jax_params(module, cfg=TINY, seed=7):
    """JAX's init (`drawn_params`), flattened, with nonzero `lora_b` and every bias and
    norm scale moved off its init."""
    params = drawn_params(module, *_example_inputs(cfg))
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    rng = np.random.RandomState(seed)
    for key in flat:
        if key.endswith("lora_b"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale")):
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


def inputs(latent=LATENT, text_embed_dim=TINY["text_embed_dim"]):
    """(latents, text states, timesteps, original sizes, target sizes, crops), numpy."""
    rng = np.random.RandomState(11)
    b = latent[0]
    return (rng.randn(*latent).astype(np.float32), rng.randn(b, TEXT_LEN, text_embed_dim).astype(np.float32),
            np.asarray([999.0, 312.5], np.float32)[:b], np.asarray([[1024, 768], [512, 512]], np.float32)[:b],
            np.asarray([[1024, 1024], [640, 512]], np.float32)[:b], np.asarray([[0, 0], [16, 8]], np.float32)[:b])


@functools.lru_cache(maxsize=None)
def jax_apply(lora_rank, use_scan, sizes=True):
    module = JaxCogView4(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1), dtype=jnp.float32,
                         use_scan=use_scan)
    flat = jax_params(module)
    x = [jnp.asarray(a) for a in inputs()]
    if sizes:
        out = jax.jit(lambda p: module.apply({"params": p}, *x[:3], original_size=x[3], target_size=x[4],
                                             crop_coords=x[5]))(unflatten(flat))
    else:
        out = jax.jit(lambda p: module.apply({"params": p}, *x[:3]))(unflatten(flat))
    return flat, np.asarray(out)


def jax_embedding(monkeypatch, module=cogview4_transformer):
    """Give the port's `module` JAX's sinusoidal embedding of the same values."""
    monkeypatch.setattr(module, "sinusoidal_timestep_embedding", lambda t, dim: torch.from_numpy(
        np.array(jax_timestep_embedding(jnp.asarray(t.cpu().numpy()), dim))).to(t.device))


def port_model(flat, lora_rank=0, cfg=TINY):
    model = CogView4Transformer2DModel(**cfg, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1),
                                       dtype=torch.float32)
    return load_flax_params(model, flat)


def test_timestep_and_size_embeddings_within_two_ulps_of_the_angle():
    t = np.asarray([999.0, 312.5, 1024.0, 768.0, 0.0, 16.0], np.float32)
    ref = np.asarray(jax_timestep_embedding(jnp.asarray(t), 256))
    got = sinusoidal_timestep_embedding(torch.from_numpy(t), 256).numpy()
    np.testing.assert_allclose(got, ref, atol=2 * float(np.spacing(np.float32(1024.0))), rtol=0)


@pytest.mark.parametrize("lora_rank,use_scan", [(0, False), (4, False), (4, True)], ids=["base", "lora", "lora_scan"])
def test_transformer_matches_jax(lora_rank, use_scan, monkeypatch):
    jax_embedding(monkeypatch)
    flat, ref = jax_apply(lora_rank, use_scan)
    if use_scan:
        assert any(k.startswith("transformer_blocks_scan.block") for k in flat)
    model = port_model(flat, lora_rank)
    with torch.no_grad():
        x = [torch.from_numpy(a) for a in inputs()]
        out = model(*x[:3], original_size=x[3], target_size=x[4], crop_coords=x[5])
    assert out.dtype == torch.float32 and out.shape == LATENT
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_missing_sizes_take_zeros_as_in_jax(monkeypatch):
    """No original size, target size or crop: zeros are embedded, as JAX :140 does."""
    jax_embedding(monkeypatch)
    flat, ref = jax_apply(4, False, sizes=False)
    model = port_model(flat, 4)
    with torch.no_grad():
        x = [torch.from_numpy(a) for a in inputs()]
        out = model(*x[:3])
        zeros = model(*x[:3], original_size=torch.zeros(2, 2), target_size=torch.zeros(2, 2),
                      crop_coords=torch.zeros(2, 2))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert torch.equal(out, zeros)


def test_padded_text_slots_are_joint_attention_keys_as_in_jax(monkeypatch):
    """The GLM states' padded slots (zeros from the offline encoder) are keys
    for every image query: zeroing slot 7 of 8, a pad slot, still moves the
    image output on both sides, by the same amount (JAX :74 passes no mask)."""
    jax_embedding(monkeypatch)
    module = JaxCogView4(**TINY, dtype=jnp.float32, use_scan=False)
    flat = jax_params(module)
    x = list(inputs())
    padded = [a.copy() for a in x]
    padded[1][:, 7] = 0.0
    apply = jax.jit(lambda p, *a: module.apply({"params": p}, *a[:3], original_size=a[3], target_size=a[4],
                                              crop_coords=a[5]))
    ref = [np.asarray(apply(unflatten(flat), *map(jnp.asarray, v))) for v in (x, padded)]
    model = port_model(flat)
    with torch.no_grad():
        got = [model(*[torch.from_numpy(a) for a in v[:3]], original_size=torch.from_numpy(v[3]),
                     target_size=torch.from_numpy(v[4]), crop_coords=torch.from_numpy(v[5])).numpy()
               for v in (x, padded)]
    assert np.abs(ref[0] - ref[1]).max() > 1e-4
    np.testing.assert_allclose(got[0] - got[1], ref[0] - ref[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("text_len,ph,pw,head_dim", [(8, 4, 6, 64), (1024, 64, 64, 128)],
                         ids=["tiny", "cogview4_1024"])
def test_rope_tables_match_jax(text_len, ph, pw, head_dim):
    """The joint sequence's (S, head_dim) tables: the identity on the text
    rows, then JAX's 2D RoPE repeated in pairs, within one ulp of 1.0 (JAX
    :69-73, :149)."""
    cos, sin = jax_axial_rope_freqs(head_dim, (ph, pw), (0.5, 0.5))
    ref_cos = np.concatenate([np.ones((text_len, head_dim), np.float32), np.repeat(np.asarray(cos), 2, axis=-1)])
    ref_sin = np.concatenate([np.zeros((text_len, head_dim), np.float32), np.repeat(np.asarray(sin), 2, axis=-1)])
    got_cos, got_sin = cogview4_rope_tables(text_len, ph, pw, head_dim)
    assert got_cos.dtype == torch.float32 and got_cos.shape == (text_len + ph * pw, head_dim)
    for got, ref in ((got_cos, ref_cos), (got_sin, ref_sin)):
        np.testing.assert_allclose(got.numpy(), ref, atol=float(np.spacing(np.float32(1.0))), rtol=0)
    assert torch.equal(got_cos[:text_len], torch.ones(text_len, head_dim)) and not got_sin[:text_len].any()


def test_patchify_round_trip_in_jax_order():
    x = np.random.RandomState(3).randn(2, 4, 8, 12).astype(np.float32)
    p = patchify(torch.from_numpy(x), 2)
    # JAX :127-129
    ref = x.reshape(2, 4, 4, 2, 6, 2).transpose(0, 2, 4, 1, 3, 5).reshape(2, 24, 16)
    np.testing.assert_array_equal(p.numpy(), ref)
    assert torch.equal(unpatchify(p, 2, 4, 8, 12), torch.from_numpy(x))


def _jax_param_count(**kw):
    module = JaxCogView4(**{**JAX_CONFIG, **kw}, use_scan=True)
    cfg = {**JAX_CONFIG, **kw}
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *_example_inputs(cfg)))["params"]
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_full_width_parameter_counts_equal_jax():
    """CogView4-6B at full width (28 blocks, 32 heads x 128) under the meta
    device holds JAX's count under `jax.eval_shape`; widened to 32 input
    channels with LoRA rank 128 (the canny control example), too."""
    assert COGVIEW4_TRANSFORMER_CONFIG == JAX_CONFIG
    with torch.device("meta"):
        base = CogView4Transformer2DModel(**COGVIEW4_TRANSFORMER_CONFIG)
        control = CogView4Transformer2DModel(**{**COGVIEW4_TRANSFORMER_CONFIG, "in_channels": 32}, lora_rank=128)
    n_base = sum(p.numel() for p in base.parameters())
    assert n_base == _jax_param_count() == 6_366_903_360
    n_control = sum(p.numel() for p in control.parameters())
    assert n_control == _jax_param_count(in_channels=32, lora_rank=128) == 6_631_406_656
    n_lora = sum(p.numel() for name, p in control.named_parameters() if ".lora_" in name)
    assert n_lora == 264_241_152 and control.patch_embed.proj.weight.numel() + 4096 == 528_384
    assert len(base.transformer_blocks) == 28


def test_seeded_init_is_reproducible_and_keeps_lora_b_zero():
    def build():
        return init_parameters_(CogView4Transformer2DModel(**TINY, lora_rank=4, dtype=torch.float32),
                                torch.Generator().manual_seed(3))

    a, b = build(), build()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("lora_B.weight"):
            assert not pa.any()


def test_lora_and_full_rank_exports_equal_jax(tmp_path):
    """The adapter and the full-rank model the port's spec writes have the
    keys, layouts and values of the JAX spec's (`cogview4_key_map`'s export
    names); the adapter loads back into a fresh model through the port's runner
    path with peft names and with JAX's flax names."""
    from safetensors.numpy import load_file as np_load_file

    from finetrainers_tpu.models.cogview4 import CogView4ModelSpecification as JaxSpec
    from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
    from finetrainers_tpu.models.modeling_utils import unflatten_params
    from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, apply_lora_to_module_params, extract_lora_state_dict
    from finetrainers_tpu_torch.models.cogview4 import CogView4ModelSpecification
    from finetrainers_tpu_torch.models.modeling_utils import ModelHandle

    flat = jax_apply(4, False)[0]
    config = {"r": 4, "lora_alpha": 8.0, "target_modules": "transformer_blocks.*(to_q|to_k|to_v|to_out.0)"}
    jax_spec = JaxSpec(transformer_config=TINY)
    lora_flat = {k: v for k, v in flat.items() if k.endswith(("lora_a", "lora_b"))}
    jax_spec._save_lora_weights(str(tmp_path / "jax"), lora_flat, config)
    spec = CogView4ModelSpecification(device="cpu", transformer_config=TINY, transformer_dtype=torch.float32,
                                      lora_rank=4, lora_alpha=8.0)
    module = port_model(flat, 4)
    spec._save_lora_weights(str(tmp_path / "port"), extract_lora_state_dict(module), config)
    ref, got = (np_load_file(str(tmp_path / side / LORA_WEIGHTS_NAME)) for side in ("jax", "port"))
    assert sorted(got) == sorted(ref) and len(ref) == 2 * 6 * 2
    assert "transformer.transformer_blocks.1.attn1.to_out.0.lora_B.weight" in ref
    assert "transformer.transformer_blocks.0.ff.net.0.proj.lora_A.weight" in ref
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for state in (ref, lora_flat):
        fresh = spec.load_diffusion_models()["transformer"].module
        apply_lora_to_module_params(fresh, {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                                    key_map=spec.transformer_key_map)
        for name, value in extract_lora_state_dict(fresh).items():
            np.testing.assert_array_equal(value.numpy(), ref["transformer." + name], err_msg=name)
    jax_module = JaxCogView4(**TINY, lora_rank=4, lora_alpha=8.0, dtype=jnp.float32, use_scan=False)
    jax_spec._save_model(str(tmp_path / "jax_full"), JaxHandle(jax_module, unflatten_params(flat),
                                                                 dict(jax_spec.transformer_config)))
    spec._save_model(str(tmp_path / "port_full"), ModelHandle(module, dict(spec.transformer_config)))
    name = "diffusion_pytorch_model.safetensors"
    ref, got = (np_load_file(str(tmp_path / side / name)) for side in ("jax_full", "port_full"))
    assert sorted(got) == sorted(ref) and not any("lora" in key for key in ref)
    assert {"patch_embed.proj.weight", "time_condition_embed.timestep_embedder.linear_1.weight",
            "transformer_blocks.0.adaln.linear.weight", "transformer_blocks.0.attn1.norm_q.weight",
            "norm_out.linear.weight"} <= set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
