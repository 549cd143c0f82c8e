"""Wan 2.1 image-to-video: the JAX package against the port, module by module
and as a request.

A tiny I2V model in fp32 (2 blocks, 2 heads of 64, ffn 48, text width 32,
image_dim 24, in_channels 10 = 4 noisy + 2 mask + 4 condition latents) and a
tiny generic VAE (temporal ratio 2, spatial 2), with JAX's weights carried
across (`load_flax_params`, `load_flax_vae_params`; nonzero `lora_b`, noise on
every bias, norm scale and table) and every random draw handed over:
  - the transformer with and without image embeds, LoRA rank 0 and 4, under
    `auto` and `sage` (JAX's Pallas int8 kernel in interpret mode), each value
    of each in two of four cases: atol 1e-4
    (tens of fp32 stages summed in another order; one flipped int8 code would
    show as ~1e-3);
  - the bridge of the image keys, both ways, bit-equal;
  - `prepare_latents` with and without `last_image` (FLF2V): moments within
    1e-4, the mask equal;
  - one request through `WanPipeline` built with the image encoder, under
    Euler and UniPC (the scheduler config in `tmp_path`): uint8 videos within
    1 level, at least 99% equal (fp32 sums in another order can move a value
    across a rounding boundary of the final `* 255` cast);
  - the two entry-point behaviours of the JAX package that the port keeps: the
    image encoder is loaded but never wired in, and serving's condition
    latents are the VAE's raw means where training's are normalised.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.wan import WanModelSpecification as JaxSpec
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu.models.wan.base_specification import _OfflineImageEncoder as JaxImageEncoder
from finetrainers_tpu.models.wan.weights import export_wan_transformer_state_dict, load_wan_transformer_params
from finetrainers_tpu.ops import attention_provider as jax_attention_provider
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle
from finetrainers_tpu_torch.models.wan import WanModelSpecification, WanTransformer3DModel, load_flax_params
from finetrainers_tpu_torch.models.wan.base_specification import _OfflineImageEncoder
from finetrainers_tpu_torch.ops import attention_provider
from finetrainers_tpu_torch.processors import HashEncoder
from finetrainers_tpu_torch.trainer.sft_trainer.trainer import _process_condition
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

IMAGE_DIM = 24
TINY = dict(in_channels=10, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=2, ffn_dim=48, text_dim=32, freq_dim=16, image_dim=IMAGE_DIM)
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, spatial_downsample=(True,),
              temporal_downsample=(True,))
VAE_CONFIG = {"latent_channels": 4, "spatial_compression_ratio": 2, "temporal_compression_ratio": 2}
LATENT = (2, 4, 3, 4, 6)
IMAGE_TOKENS = 5
ATOL = 1e-4
REQUEST = dict(prompt="a red fox runs through fresh snow", height=16, width=24, num_frames=5,
               num_inference_steps=3, guidance_scale=5.0, seed=0)


def _flat(params, seed=7):
    """Flattened JAX parameters with nonzero lora_b and every bias, norm scale
    and table moved off its init, so a dropped or swapped leaf shows."""
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    rng = np.random.RandomState(seed)
    for key in flat:
        if key.endswith("lora_b"):
            flat[key] = (rng.randn(*flat[key].shape) * 0.5).astype(np.float32)
        elif key.endswith(("bias", "scale", "scale_shift_table")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    return flat


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


@functools.lru_cache(maxsize=None)
def _jax_transformer(lora_rank):
    module = JaxWan(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1), dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 10, 1, 4, 4)), jnp.zeros((1, 8, 32)),
                          jnp.zeros((1,)),
                          encoder_hidden_states_image=jnp.zeros((1, 4, IMAGE_DIM)))
    return module, _flat(params)


def _port_transformer(lora_rank, flat):
    port = WanTransformer3DModel(**TINY, lora_rank=lora_rank, lora_alpha=2.0 * max(lora_rank, 1), dtype=torch.float32)
    return load_flax_params(port, flat).eval()


@functools.lru_cache(maxsize=None)
def _jax_vae():
    """The tiny JAX VAE (its encode and decode jitted: eager flax costs
    minutes) and its flat parameters."""
    module = jax_ae.AutoencoderKL3D(jax_ae.AutoencoderConfig(**VAE_KW), dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 3, 1, 2, 2)))
    return module, _flat(params, seed=5)


_vae_apply = jax.jit(lambda module, params, x, decode: module.apply(
    {"params": params}, x, method=jax_ae.AutoencoderKL3D.decode if decode else jax_ae.AutoencoderKL3D.encode),
    static_argnums=(0, 3))


class _JittedVAE(JaxHandle):
    def apply(self, x, method=None):
        return _vae_apply(self.module, self.params, x, method is jax_ae.AutoencoderKL3D.decode)


def _vaes(mean=None, std=None):
    """(JAX handle, port handle) of the tiny VAE with the given latent statistics (identity by default)."""
    module, flat = _jax_vae()
    config = dict(VAE_CONFIG, latents_mean=np.zeros(4, np.float32) if mean is None else mean,
                  latents_std=np.ones(4, np.float32) if std is None else std)
    port = autoencoders.load_flax_vae_params(autoencoders.AutoencoderKL3D(
        autoencoders.AutoencoderConfig(**VAE_KW), dtype=torch.float32), flat).eval()
    return _JittedVAE(module, _unflatten(flat), dict(config)), ModelHandle(port, dict(config))


def _specs(**kw):
    jax_spec = JaxSpec(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW), **kw)
    jax_spec.transformer_dtype = jnp.float32
    port_spec = WanModelSpecification(transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW),
                                      device="cpu", transformer_dtype=torch.float32, vae_dtype=torch.float32, **kw)
    return jax_spec, port_spec


def _inputs():
    rng = np.random.RandomState(11)
    latents = rng.randn(*LATENT[:1], 10, *LATENT[2:]).astype(np.float32)
    context = rng.randn(2, 16, 32).astype(np.float32)
    image = (rng.randn(2, IMAGE_TOKENS, IMAGE_DIM) * 0.5).astype(np.float32)
    timesteps = np.asarray([999.0, 312.5], np.float32)
    mask = np.zeros((2, 16), np.int32)
    mask[0, :16] = 1
    mask[1, :5] = 1
    return latents, context, timesteps, mask, image


@pytest.mark.parametrize("provider,lora_rank,with_image", [
    ("auto", 0, True), ("auto", 4, False), ("sage", 4, True), ("sage", 0, False),
], ids=["auto-rank0-image", "auto-lora-no_image", "sage-lora-image", "sage-rank0-no_image"])
def test_i2v_transformer_matches_jax(provider, lora_rank, with_image):
    module, flat = _jax_transformer(lora_rank)
    latents, context, timesteps, mask, image = _inputs()
    image = image if with_image else None
    apply = jax.jit(lambda p, x, c, t, m, i: module.apply({"params": p}, x, c, t, encoder_hidden_states_image=i,
                                                          encoder_attention_mask=m))
    with jax_attention_provider(provider):
        ref = apply(_unflatten(flat), *map(jnp.asarray, (latents, context, timesteps, mask)),
                    None if image is None else jnp.asarray(image))
    port = _port_transformer(lora_rank, flat)
    with torch.no_grad(), attention_provider(provider):
        out = port(*map(torch.from_numpy, (latents, context, timesteps)), encoder_attention_mask=torch.from_numpy(mask),
                   encoder_hidden_states_image=None if image is None else torch.from_numpy(image))
    assert out.dtype == torch.float32 and out.shape == (2, 4, *LATENT[2:])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_image_branch_changes_the_output_only_with_image_embeds():
    """Without embeds the branch is skipped (the output equals a T2V model's
    with the same weights); with them it adds its own attention."""
    _, flat = _jax_transformer(0)
    latents, context, timesteps, mask, image = _inputs()
    i2v = _port_transformer(0, flat)
    t2v = WanTransformer3DModel(**{**TINY, "image_dim": None}, dtype=torch.float32)
    t2v.load_state_dict({k: v for k, v in i2v.state_dict().items()
                         if "image_embedder" not in k and "add_" not in k and "norm_added_k" not in k})
    args = [*map(torch.from_numpy, (latents, context, timesteps))]
    with torch.no_grad():
        plain = i2v(*args, encoder_attention_mask=torch.from_numpy(mask))
        assert torch.equal(plain, t2v(*args, encoder_attention_mask=torch.from_numpy(mask)))
        with_image = i2v(*args, encoder_attention_mask=torch.from_numpy(mask),
                         encoder_hidden_states_image=torch.from_numpy(image))
    assert (with_image - plain).abs().max() > 1e-3


def test_bridge_round_trips_the_image_keys():
    """JAX's parameters into the port (strict), and the port's state dict back
    through JAX's loader (`load_wan_transformer_params`), bit-equal; JAX's
    export of the image keys is the port's state dict."""
    module, flat = _jax_transformer(0)
    port = _port_transformer(0, flat)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    for key in ("condition_embedder.image_embedder.norm1.weight", "condition_embedder.image_embedder.norm1.bias",
                "condition_embedder.image_embedder.ff.net.0.proj.weight",
                "condition_embedder.image_embedder.ff.net.2.bias", "condition_embedder.image_embedder.norm2.weight",
                "blocks.1.attn2.add_k_proj.weight", "blocks.1.attn2.add_v_proj.bias",
                "blocks.1.attn2.norm_added_k.weight"):
        assert key in state, key
    exported = export_wan_transformer_state_dict(_unflatten(flat))
    assert sorted(exported) == sorted(state)
    for key, value in exported.items():
        np.testing.assert_array_equal(state[key], np.asarray(value), err_msg=key)
    back = load_wan_transformer_params(state, jax.eval_shape(lambda: _unflatten(flat)))
    back = {k: np.asarray(v) for k, v in flatten_params(back).items()}
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("flf2v", [False, True], ids=["i2v", "flf2v"])
def test_prepare_latents_matches_jax(flf2v):
    jax_spec, port_spec = _specs()
    jax_vae, port_vae = _vaes()
    video = np.random.RandomState(3).uniform(-1, 1, (5, 3, 16, 24)).astype(np.float32)
    last = video[-1] * 0.5 if flf2v else None
    ref = jax_spec.prepare_latents(jax_vae, video=video, last_image=last)
    out = port_spec.prepare_latents(port_vae, video=torch.from_numpy(video), last_image=last)
    assert sorted(out) == sorted(ref) == ["latent_condition", "latent_condition_mask", "latents", "latents_mean",
                                          "latents_std"]
    for key in ("latents", "latent_condition"):
        assert out[key].shape == ref[key].shape == (1, 8, 3, 8, 12)
        np.testing.assert_allclose(out[key].numpy(), ref[key], atol=ATOL, rtol=0, err_msg=key)
    np.testing.assert_array_equal(out["latent_condition_mask"].numpy(), ref["latent_condition_mask"])
    assert out["latent_condition_mask"].shape == (1, 2, 3, 8, 12)
    assert out["latent_condition_mask"][0, 0, -1].all() == flf2v and not out["latent_condition_mask"][0, 1, -1].any()
    collated = port_spec.collate_latents([out, out])
    assert collated["latent_condition"].shape == (2, 8, 3, 8, 12)
    assert collated["latent_condition_mask"].shape == (2, 2, 3, 8, 12)


def _write_unipc(tmp_path):
    (tmp_path / "scheduler").mkdir()
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "UniPCMultistepScheduler", "flow_shift": 3.0, "solver_order": 2, "solver_type": "bh2"}))
    return str(tmp_path)


@pytest.mark.parametrize("scheduler", ["euler", "unipc"])
def test_i2v_request_with_the_image_encoder_matches_jax(scheduler, tmp_path):
    path = _write_unipc(tmp_path) if scheduler == "unipc" else None
    jax_spec, port_spec = _specs(pretrained_model_name_or_path=path)
    module, flat = _jax_transformer(0)
    jax_vae, port_vae = _vaes()
    jax_pipe = jax_spec.load_pipeline(transformer=JaxHandle(module, _unflatten(flat), dict(TINY)), vae=jax_vae,
                                      text_encoder=JaxHashEncoder(hidden_size=32, max_length=16))
    jax_pipe = dataclasses.replace(jax_pipe, image_encoder=JaxImageEncoder(IMAGE_DIM))
    port_pipe = port_spec.load_pipeline(transformer=ModelHandle(_port_transformer(0, flat), dict(TINY)),
                                        vae=port_vae, text_encoder=HashEncoder(hidden_size=32, max_length=16))
    assert port_pipe.image_encoder is None and jax_spec.load_pipeline(
        transformer=jax_pipe.transformer, vae=jax_vae, text_encoder=jax_pipe.text_encoder).image_encoder is None
    port_pipe = dataclasses.replace(port_pipe, image_encoder=_OfflineImageEncoder(IMAGE_DIM))
    assert type(port_pipe.scheduler).__name__ == type(jax_pipe.scheduler).__name__ == (
        "UniPCFlowScheduler" if path else "FlowMatchEulerScheduler")
    image = np.random.RandomState(4).randint(0, 256, (16, 24, 3), dtype=np.uint8)
    ref = jax_pipe(**REQUEST, image=image)
    shape = port_pipe.latent_shape(REQUEST["num_frames"], REQUEST["height"], REQUEST["width"])
    draw = np.array(jax.random.normal(jax.random.PRNGKey(REQUEST["seed"]), shape, jnp.float32))
    video = port_pipe(**REQUEST, image=image, latents=torch.from_numpy(draw))
    assert video.shape == ref.shape == (5, 16, 24, 3) and video.dtype == np.uint8
    diff = np.abs(video.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    # The image reaches the image-KV branch: without the encoder the request differs.
    plain = dataclasses.replace(port_pipe, image_encoder=None)(**REQUEST, image=image, latents=torch.from_numpy(draw))
    assert not np.array_equal(plain, video)


def test_image_encoder_is_loaded_but_not_wired_in(tmp_path):
    """JAX bug 1, kept: the spec loads the image encoder (its embeds the same
    bytes as JAX's stand-in), `load_pipeline` builds the pipeline without it,
    and the trainer's condition step passes no image, so no image embeds reach
    the model from either entry point. A local CLIP-vision checkpoint raises."""
    jax_spec, port_spec = _specs()
    models = port_spec.load_condition_models()
    image = np.random.RandomState(5).randint(0, 256, (16, 24, 3), dtype=np.uint8)
    np.testing.assert_array_equal(models["image_encoder"].encode_image(image),
                                  JaxImageEncoder(IMAGE_DIM).encode_image(image))
    assert models["image_encoder"].encode_image(image).shape == (1, 257, IMAGE_DIM)
    ids = []
    conditions = _process_condition(port_spec, models, ids, caption="a fox", image=image, sample_id="a")
    assert sorted(conditions) == ["encoder_attention_mask", "encoder_hidden_states"] and ids == ["a"]
    with_image = port_spec.prepare_conditions("a fox", text_encoder=models["text_encoder"], image=image,
                                              image_encoder=models["image_encoder"])
    np.testing.assert_array_equal(with_image["encoder_hidden_states_image"],
                                  jax_spec.prepare_conditions("a fox", text_encoder=JaxHashEncoder(4096, 128),
                                                              image=image, image_encoder=JaxImageEncoder(IMAGE_DIM))
                                  ["encoder_hidden_states_image"])
    _, port_vae = _vaes()
    assert port_spec.load_pipeline(transformer=ModelHandle(_port_transformer(0, _jax_transformer(0)[1]), dict(TINY)),
                                   vae=port_vae).image_encoder is None
    (tmp_path / "image_encoder").mkdir()
    (tmp_path / "image_encoder" / "config.json").write_text("{}")
    _, local = _specs(pretrained_model_name_or_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        local.load_condition_models()


def test_serving_condition_latents_are_not_normalised():
    """JAX bug 2, kept: with non-identity latent statistics, the pipeline's
    condition channels are the VAE's raw posterior mean of the first-frame
    video (JAX pipeline.py:63-75), equal to JAX's, while the training forward
    normalises the condition moments (base_specification.py:251-255)."""
    mean = np.asarray([0.5, -0.25, 1.0, 0.1], np.float32)
    std = np.asarray([2.0, 0.5, 1.5, 1.0], np.float32)
    jax_vae, port_vae = _vaes(mean, std)
    _, port_spec = _specs()
    module, flat = _jax_transformer(0)
    port_pipe = port_spec.load_pipeline(transformer=ModelHandle(_port_transformer(0, flat), dict(TINY)),
                                        vae=port_vae, text_encoder=HashEncoder(hidden_size=32, max_length=16))
    image = np.random.RandomState(6).randint(0, 256, (16, 24, 3), dtype=np.uint8)
    with torch.no_grad():
        cond = port_pipe.image_condition(image, 5, 16, 24)
    frames = np.zeros((1, 3, 5, 16, 24), np.float32)
    frames[:, :, 0] = np.moveaxis(image.astype(np.float32) / 127.5 - 1.0, -1, 0)
    raw = np.split(np.asarray(jax_vae.apply(jnp.asarray(frames), method=jax_ae.AutoencoderKL3D.encode)), 2, axis=1)[0]
    assert cond.shape == (1, 2 + 4, 3, 8, 12)
    np.testing.assert_array_equal(cond[0, :2, 0].numpy(), 1.0)
    assert not cond[0, :2, 1:].any()
    np.testing.assert_allclose(cond[:, 2:].numpy(), raw, atol=ATOL, rtol=0)
    normalised = (raw - mean.reshape(1, -1, 1, 1, 1)) / std.reshape(1, -1, 1, 1, 1)
    assert np.abs(cond[:, 2:].numpy() - normalised).max() > 0.1
