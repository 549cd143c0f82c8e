"""CogVideoX transformer parity: JAX `CogVideoXTransformer3DModel.apply` against the port.

A tiny model (2 blocks, 2 heads of 64, text width 32, time width 32) in
three configurations: the 5B's 3D RoPE (per-block and scan-stacked trees),
the 2B's learned positional embedding, and CogVideoX 1.5's 3D patches
(`patch_size_t` 2) with the `ofs` embedding. Weights come from JAX's init,
carried across by `load_flax_params`, with nonzero `lora_b` and every bias,
norm scale and positional row moved off its init, so a swapped or dropped
leaf shows. Inputs: frames-first (2, 3, 4, 8, 12) latents (4 frames for the
3D patches), 8 text slots, per-sample timesteps. Both sides run fp32 under
`auto`; atol 1e-4 (tens of fp32 matmul and norm stages summed in another
order). The sinusoidal embeddings are handed over from JAX, as for Flux and
CogView4 (the packages' fp32 `exp` differ by an ulp). The RoPE tables of the
joint sequence (226 identity text rows at full width) within one ulp of 1.0
of JAX's; the patchify exact; the full-width parameter counts under the meta
device against JAX's `jax.eval_shape`; the LoRA and full-rank exports
against the JAX spec's files, key for key and value for value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.cogvideox import COGVIDEOX_2B_CONFIG as JAX_2B
from finetrainers_tpu.models.cogvideox import COGVIDEOX_5B_CONFIG as JAX_5B
from finetrainers_tpu.models.cogvideox.transformer import CogVideoXTransformer3DModel as JaxCogVideoX
from finetrainers_tpu.models.cogvideox.transformer import cogvideox_rope_freqs as jax_rope_freqs
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu_torch.models.cogvideox import (
    COGVIDEOX_2B_CONFIG,
    COGVIDEOX_5B_CONFIG,
    CogVideoXTransformer3DModel,
    cogvideox_rope_tables,
    load_flax_params,
    patchify,
    unpatchify,
)
from finetrainers_tpu_torch.models.cogvideox import transformer as cogvideox_transformer
from finetrainers_tpu_torch.models.layers import init_parameters_
from test_torch_cogview4_transformer import jax_embedding as _jax_embedding
from test_torch_cogview4_transformer import unflatten
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, patch_size=2, num_attention_heads=2, attention_head_dim=64,
            num_layers=2, text_embed_dim=32, time_embed_dim=32, use_rotary_positional_embeddings=True,
            use_learned_positional_embeddings=False)
VARIANTS = {
    "rope_5b": {},
    "learned_2b": dict(use_rotary_positional_embeddings=False, use_learned_positional_embeddings=True,
                       sample_frames=8, sample_height=8, sample_width=12),
    "patch_t_ofs": dict(patch_size_t=2, ofs_embed_dim=16),
}
TEXT_LEN = 8
ATOL = 1e-4


def config(variant):
    return {**TINY, **VARIANTS[variant]}


def inputs(variant):
    """(latents (B, F, C, H, W), text states, timesteps, ofs), numpy."""
    rng = np.random.RandomState(11)
    frames = 4 if config(variant).get("patch_size_t") else 3
    return (rng.randn(2, frames, 4, 8, 12).astype(np.float32), rng.randn(2, TEXT_LEN, 32).astype(np.float32),
            np.asarray([999.0, 312.0], np.float32), np.asarray([2.0, 2.0], np.float32))


def jax_params(module, variant, seed=7):
    """JAX's init at the test's shapes (`drawn_params`), flattened, with nonzero
    `lora_b` and every bias, norm scale and positional row moved off its init."""
    x = [jnp.asarray(a) for a in inputs(variant)]
    params = drawn_params(module, *x[:3], ofs=x[3])
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    rng = np.random.RandomState(seed)
    for key in flat:
        if key.endswith("lora_b"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale", "pos_embedding")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return flat


@functools.lru_cache(maxsize=None)
def jax_model(variant, lora_rank=4, use_scan=False):
    """JAX's weights (flattened) and its jitted apply(params, latents, text, timesteps, ofs)."""
    module = JaxCogVideoX(**config(variant), lora_rank=lora_rank, lora_alpha=2.0 * lora_rank, dtype=jnp.float32,
                          use_scan=use_scan)
    return jax_params(module, variant), jax.jit(lambda p, *x: module.apply({"params": p}, *x[:3], ofs=x[3]))


@functools.lru_cache(maxsize=None)
def jax_apply(variant, lora_rank=4, use_scan=False):
    flat, apply = jax_model(variant, lora_rank, use_scan)
    return flat, np.asarray(apply(unflatten(flat), *map(jnp.asarray, inputs(variant))))


def jax_embedding(monkeypatch):
    _jax_embedding(monkeypatch, cogvideox_transformer)


def port_model(flat, variant, lora_rank=4):
    model = CogVideoXTransformer3DModel(**config(variant), lora_rank=lora_rank, lora_alpha=2.0 * lora_rank,
                                        dtype=torch.float32)
    return load_flax_params(model, flat)


@pytest.mark.parametrize("variant,use_scan", [("rope_5b", False), ("rope_5b", True), ("learned_2b", False),
                                              ("patch_t_ofs", False)],
                         ids=["rope_5b", "rope_5b_scan", "learned_2b", "patch_t_ofs"])
def test_transformer_matches_jax(variant, use_scan, monkeypatch):
    jax_embedding(monkeypatch)
    flat, ref = jax_apply(variant, use_scan=use_scan)
    if use_scan:
        assert any(k.startswith("transformer_blocks_scan.block") for k in flat)
    if variant == "learned_2b":
        assert flat["pos_embedding"].shape == (1, 226 + 3 * 4 * 6, 128)
    if variant == "patch_t_ofs":
        assert "ofs_embedding_linear_2.kernel" in flat
    model = port_model(flat, variant)
    with torch.no_grad():
        x = [torch.from_numpy(a) for a in inputs(variant)]
        out = model(*x[:3], ofs=x[3])
    assert out.dtype == torch.float32 and out.shape == x[0].shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_padded_text_slots_are_joint_attention_keys_as_in_jax(monkeypatch):
    """The T5 states' padded slots (zeros from the offline encoder) are keys
    for every video query: zeroing slot 7 of 8 still moves the video output
    on both sides, by the same amount (JAX :106 passes no kv_lens)."""
    jax_embedding(monkeypatch)
    flat, apply = jax_model("rope_5b")
    x = list(inputs("rope_5b"))
    padded = [a.copy() for a in x]
    padded[1][:, 7] = 0.0
    ref = [np.asarray(apply(unflatten(flat), *map(jnp.asarray, v))) for v in (x, padded)]
    model = port_model(flat, "rope_5b")
    with torch.no_grad():
        got = [model(*[torch.from_numpy(a) for a in v[:3]]).numpy() for v in (x, padded)]
    assert np.abs(ref[0] - ref[1]).max() > 1e-4
    np.testing.assert_allclose(got[0] - got[1], ref[0] - ref[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("text_len,grid", [(8, (3, 4, 6)), (226, (21, 30, 48))], ids=["tiny", "crush_smol_81x480x768"])
def test_rope_tables_match_jax(text_len, grid):
    """The joint sequence's (S, 64) tables: the identity on the text rows,
    then JAX's 3D RoPE (slots 8/12/12 over frame, row, col) repeated in
    pairs, within one ulp of 1.0 (JAX :34-40, :99-109); at the example's
    bucket S = 226 + 30,240 = 30,466."""
    cos, sin = jax_rope_freqs(64, *grid)
    ref_cos = np.concatenate([np.ones((text_len, 64), np.float32), np.repeat(np.asarray(cos), 2, axis=-1)])
    ref_sin = np.concatenate([np.zeros((text_len, 64), np.float32), np.repeat(np.asarray(sin), 2, axis=-1)])
    got_cos, got_sin = cogvideox_rope_tables(text_len, *grid, 64)
    assert got_cos.dtype == torch.float32 and got_cos.shape == (text_len + int(np.prod(grid)), 64)
    for got, ref in ((got_cos, ref_cos), (got_sin, ref_sin)):
        np.testing.assert_allclose(got.numpy(), ref, atol=float(np.spacing(np.float32(1.0))), rtol=0)
    assert torch.equal(got_cos[:text_len], torch.ones(text_len, 64)) and not got_sin[:text_len].any()


@pytest.mark.parametrize("pt", [1, 2])
def test_patchify_round_trip_in_jax_order(pt):
    x = np.random.RandomState(3).randn(2, 4, 4, 8, 12).astype(np.float32)
    p = patchify(torch.from_numpy(x), 2, pt)
    # JAX :173-174
    ref = x.reshape(2, 4 // pt, pt, 4, 4, 2, 6, 2).transpose(0, 1, 4, 6, 2, 3, 5, 7).reshape(2, -1, pt * 16)
    np.testing.assert_array_equal(p.numpy(), ref)
    assert torch.equal(unpatchify(p, (4, 8, 12), 4, 2, pt), torch.from_numpy(x))


def _jax_param_count(cfg, **kw):
    module = JaxCogVideoX(**cfg, **kw, use_scan=True)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 4, 4)),
                                                jnp.zeros((1, 8, 4096)), jnp.zeros((1,))))["params"]
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_full_width_parameter_counts_equal_jax():
    """CogVideoX-5B at full width (42 blocks, 48 heads x 64) under the meta
    device holds JAX's count under `jax.eval_shape`, and at the crush_smol
    example's LoRA rank 32 its 74,317,824 LoRA parameters (every block's q, k,
    v, out and both feed-forward layers); the 2B config too."""
    assert COGVIDEOX_5B_CONFIG == JAX_5B and COGVIDEOX_2B_CONFIG == JAX_2B
    with torch.device("meta"):
        base = CogVideoXTransformer3DModel(**COGVIDEOX_5B_CONFIG)
        lora = CogVideoXTransformer3DModel(**COGVIDEOX_5B_CONFIG, lora_rank=32)
        small = CogVideoXTransformer3DModel(**COGVIDEOX_2B_CONFIG)
    n_base = sum(p.numel() for p in base.parameters())
    assert n_base == _jax_param_count(JAX_5B) == 5_569_760_832
    n_lora = sum(p.numel() for name, p in lora.named_parameters() if ".lora_" in name)
    assert n_lora == 74_317_824 and n_base + n_lora == _jax_param_count(JAX_5B, lora_rank=32)
    assert sum(p.numel() for p in small.parameters()) == _jax_param_count(JAX_2B)
    assert len(base.transformer_blocks) == 42 and small.patch_embed.pos_embedding.shape == (1, 17776, 1920)


def test_seeded_init_is_reproducible_and_keeps_lora_b_zero():
    def build():
        return init_parameters_(CogVideoXTransformer3DModel(**config("learned_2b"), lora_rank=4,
                                                            dtype=torch.float32), torch.Generator().manual_seed(3))

    a, b = build(), build()
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("lora_B.weight"):
            assert not pa.any()
    assert 0.015 < float(a.patch_embed.pos_embedding.detach().std()) < 0.025


def test_lora_and_full_rank_exports_equal_jax(tmp_path):
    """The adapter and the full-rank model the port's spec writes have the
    keys, layouts and values of the JAX spec's (`cogvideox_key_map`'s export
    names); the adapter loads back into a fresh model through the port's
    runner path with peft names and with JAX's flax names."""
    from safetensors.numpy import load_file as np_load_file

    from finetrainers_tpu.models.cogvideox import CogVideoXModelSpecification as JaxSpec
    from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
    from finetrainers_tpu.models.modeling_utils import unflatten_params
    from finetrainers_tpu_torch.lora import LORA_WEIGHTS_NAME, apply_lora_to_module_params, extract_lora_state_dict
    from finetrainers_tpu_torch.models.cogvideox import CogVideoXModelSpecification
    from finetrainers_tpu_torch.models.modeling_utils import ModelHandle

    flat = jax_apply("rope_5b")[0]
    config_ = {"r": 4, "lora_alpha": 8.0, "target_modules": "transformer_blocks.*(to_q|to_k|to_v|to_out.0)"}
    jax_spec = JaxSpec(transformer_config=TINY)
    lora_flat = {k: v for k, v in flat.items() if k.endswith(("lora_a", "lora_b"))}
    jax_spec._save_lora_weights(str(tmp_path / "jax"), lora_flat, config_)
    spec = CogVideoXModelSpecification(device="cpu", transformer_config=TINY, transformer_dtype=torch.float32,
                                       lora_rank=4, lora_alpha=8.0)
    module = port_model(flat, "rope_5b")
    spec._save_lora_weights(str(tmp_path / "port"), extract_lora_state_dict(module), config_)
    ref, got = (np_load_file(str(tmp_path / side / LORA_WEIGHTS_NAME)) for side in ("jax", "port"))
    assert sorted(got) == sorted(ref) and len(ref) == 2 * 6 * 2
    assert "transformer.transformer_blocks.1.attn1.to_out.0.lora_B.weight" in ref
    assert "transformer.transformer_blocks.0.ff.net.2.lora_A.weight" in ref
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for state in (ref, lora_flat):
        fresh = spec.load_diffusion_models()["transformer"].module
        apply_lora_to_module_params(fresh, {k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                                    key_map=spec.transformer_key_map)
        for name, value in extract_lora_state_dict(fresh).items():
            np.testing.assert_array_equal(value.numpy(), ref["transformer." + name], err_msg=name)
    jax_module = JaxCogVideoX(**TINY, lora_rank=4, lora_alpha=8.0, dtype=jnp.float32, use_scan=False)
    jax_spec._save_model(str(tmp_path / "jax_full"), JaxHandle(jax_module, unflatten_params(flat),
                                                                 dict(jax_spec.transformer_config)))
    spec._save_model(str(tmp_path / "port_full"), ModelHandle(module, dict(spec.transformer_config)))
    name = "diffusion_pytorch_model.safetensors"
    ref, got = (np_load_file(str(tmp_path / side / name)) for side in ("jax_full", "port_full"))
    assert sorted(got) == sorted(ref) and not any("lora" in key for key in ref)
    assert {"patch_embed.proj.weight", "patch_embed.text_proj.weight", "time_embedding.linear_1.weight",
            "transformer_blocks.0.norm1.linear.weight", "transformer_blocks.0.attn1.norm_q.weight",
            "norm_final.weight", "norm_out.linear.weight"} <= set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
