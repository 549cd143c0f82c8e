"""The Wan serving slice as a whole: JAX `WanPipeline` against the port's.

Both packages load the tiny Wan spec in fp32 with `HashEncoder` (captions
padded to Wan's 512 text tokens, a few valid), CFG 5.0 and 2 Euler steps with
shift 3; the port gets the JAX transformer and VAE weights through the bridge
and the JAX initial draw `jax.random.normal(PRNGKey(seed), shape)` as
`latents=`. Under `auto` and under `sage` (JAX's Pallas int8 kernel in
interpret mode; each provider gets its own JAX pipeline, whose jitted step is
traced under it), the uint8 videos must agree within 1 level with at least 99%
of values equal (fp32 sums in another order can move a value across a rounding
boundary of the final `* 255` cast).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.autoencoders import AutoencoderConfig as JaxVAEConfig
from finetrainers_tpu.models.autoencoders import AutoencoderKL3D as JaxVAE
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.models.wan import WanModelSpecification as JaxSpec
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu.ops import attention_provider as jax_attention_provider
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.models.autoencoders import WAN_VAE_CONFIG, AutoencoderConfig, load_flax_vae_params
from finetrainers_tpu_torch.models.wan import WanControlModelSpecification, WanModelSpecification, load_flax_params
from finetrainers_tpu_torch.ops import attention_provider
from finetrainers_tpu_torch.processors import HashEncoder
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
            num_layers=2, ffn_dim=48, text_dim=32, freq_dim=16)
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
              spatial_downsample=(True,), temporal_downsample=(True,))
REQUEST = dict(prompt="a red fox runs through fresh snow", height=16, width=24, num_frames=5,
               num_inference_steps=2, guidance_scale=5.0, seed=0)


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


def _jax_handles(spec):
    """The JAX spec's offline `load_diffusion_models` / `load_latent_models`
    (base_specification.py:106-144), with `init` drawn by `drawn_params` to keep CPU time down."""
    module = JaxWan(**spec.transformer_config, dtype=spec.transformer_dtype)
    params = drawn_params(module, jnp.zeros((1, 4, 1, 4, 4)), jnp.zeros((1, 8, 32)),
                          jnp.zeros((1,)))
    transformer = ModelHandle(module, params, dict(spec.transformer_config))
    cfg = spec.vae_autoencoder_config
    vae_module = JaxVAE(cfg, dtype=spec.vae_dtype)
    ratio = cfg.spatial_compression_ratio
    vae_params = drawn_params(vae_module, jnp.zeros((1, 3, 1, ratio, ratio)))
    vae = ModelHandle(vae_module, vae_params, {
        "latent_channels": cfg.latent_channels, "spatial_compression_ratio": ratio,
        "temporal_compression_ratio": cfg.temporal_compression_ratio,
        "latents_mean": np.zeros((cfg.latent_channels,), np.float32),
        "latents_std": np.ones((cfg.latent_channels,), np.float32),
    })
    return transformer, vae


@pytest.fixture(scope="module")
def pipelines():
    """(JAX spec, its handles, the port's pipeline with the same weights)."""
    spec = JaxSpec(transformer_config=TINY, vae_config=JaxVAEConfig(**VAE_KW))
    spec.transformer_dtype = jnp.float32
    spec.vae_dtype = jnp.float32
    transformer, vae = _jax_handles(spec)
    port_spec = WanModelSpecification(transformer_config=TINY, vae_config=AutoencoderConfig(**VAE_KW), device="cpu",
                                      transformer_dtype=torch.float32, vae_dtype=torch.float32)
    port_transformer = port_spec.load_diffusion_models()["transformer"]
    load_flax_params(port_transformer.module, _flat(transformer.params))
    port_vae = port_spec.load_latent_models()["vae"]
    load_flax_vae_params(port_vae.module, _flat(vae.params))
    port_pipe = port_spec.load_pipeline(transformer=port_transformer, vae=port_vae,
                                        text_encoder=HashEncoder(hidden_size=32, max_length=16))
    return spec, (transformer, vae), port_pipe


@pytest.mark.parametrize("provider", ["auto", "sage"])
def test_t2v_video_matches_jax(pipelines, provider):
    spec, (transformer, vae), port_pipe = pipelines
    jax_pipe = spec.load_pipeline(transformer=transformer, vae=vae,
                                  text_encoder=JaxHashEncoder(hidden_size=32, max_length=16))
    with jax_attention_provider(provider):
        ref = jax_pipe(**REQUEST)
    shape = port_pipe.latent_shape(REQUEST["num_frames"], REQUEST["height"], REQUEST["width"])
    draw = np.array(jax.random.normal(jax.random.PRNGKey(REQUEST["seed"]), shape, jnp.float32))
    with attention_provider(provider):
        video = port_pipe(**REQUEST, latents=torch.from_numpy(draw))
    assert video.shape == ref.shape == (5, 16, 24, 3) and video.dtype == np.uint8
    diff = np.abs(video.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_seeded_draw_is_reproducible(pipelines):
    port_pipe = pipelines[2]
    request = {**REQUEST, "num_inference_steps": 1}
    np.testing.assert_array_equal(port_pipe(**request), port_pipe(**request))


def test_prepare_conditions_pad_to_512_text_tokens(pipelines):
    spec, _, port_pipe = pipelines
    for caption in ("", "a fox"):
        ref = spec.prepare_conditions(caption=caption, text_encoder=JaxHashEncoder(hidden_size=32, max_length=16))
        out = port_pipe.spec.prepare_conditions(caption=caption, text_encoder=port_pipe.text_encoder)
        assert out["encoder_hidden_states"].shape == (1, 512, 32)
        for key in ("encoder_hidden_states", "encoder_attention_mask"):
            np.testing.assert_array_equal(out[key], np.asarray(ref[key]))


def test_image_to_video_and_control_are_not_ported(pipelines):
    """Image-to-video and control conditioning are ported (the name is kept
    from when both raised): a T2V pipeline refuses a control video, which
    needs a control model (test_torch_control_wan.py serves one), and ignores
    an image, as JAX's does; a tiny I2V model serves an image request whose
    video depends on the image."""
    port_pipe = pipelines[2]
    with pytest.raises(ValueError, match="control model"):
        port_pipe(**REQUEST, control_video=np.zeros((5, 16, 24, 3), np.uint8))
    request = {**REQUEST, "num_inference_steps": 1}
    image = np.random.RandomState(2).randint(0, 256, (16, 24, 3), dtype=np.uint8)
    np.testing.assert_array_equal(port_pipe(**request, image=image), port_pipe(**request))
    i2v_spec = WanModelSpecification(transformer_config={**TINY, "in_channels": 4 + 2 + 4, "image_dim": 32},
                                     vae_config=AutoencoderConfig(**VAE_KW), device="cpu",
                                     transformer_dtype=torch.float32, vae_dtype=torch.float32)
    i2v_pipe = i2v_spec.load_pipeline(text_encoder=HashEncoder(hidden_size=32, max_length=16))
    videos = [i2v_pipe(**request, image=img) for img in (image, 255 - image)]
    assert all(v.shape == (5, 16, 24, 3) and v.dtype == np.uint8 for v in videos)
    assert not np.array_equal(*videos)


def test_registry_resolves_wan_and_spec_serves_offline():
    """`wan` resolves for lora and full-finetune, and its control types to the
    control spec; the spec's offline components are the JAX package's fallbacks."""
    for training_type in ("lora", "full-finetune"):
        assert get_model_specification_cls("wan", training_type) is WanModelSpecification
    for training_type in ("control-lora", "control-full-finetune"):
        assert get_model_specification_cls("wan", training_type) is WanControlModelSpecification
    spec = WanModelSpecification(device="cpu")
    assert spec.vae_autoencoder_config == WAN_VAE_CONFIG
    assert (WAN_VAE_CONFIG.spatial_compression_ratio, WAN_VAE_CONFIG.temporal_compression_ratio) == (8, 4)
    encoder = spec.load_condition_models()["text_encoder"]
    assert (encoder.hidden_size, encoder.max_length) == (4096, 128)
    tiny = WanModelSpecification(transformer_config=TINY, device="cpu")
    assert tiny.load_diffusion_models()["scheduler"].shift == 3.0
