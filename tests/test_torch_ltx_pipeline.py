"""The serving slice as a whole: JAX `LTXPipeline` against the port's.

Both packages load the tiny LTX spec in fp32 with `HashEncoder`, CFG 3.0 and
2 Euler steps; the port gets the JAX transformer and VAE weights through the
bridge and the JAX initial draw `jax.random.normal(PRNGKey(seed), shape)` as
`latents=`. The uint8 videos must agree within 1 level with at least 99% of
values equal (fp32 sums in another order can move a value across a rounding
boundary of the final `* 255` cast). Sigma grids and `HashEncoder` outputs
must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.autoencoders import AutoencoderConfig as JaxVAEConfig
from finetrainers_tpu.models.autoencoders import AutoencoderKL3D as JaxVAE
from finetrainers_tpu.models.ltx_video import LTXVideoModelSpecification as JaxSpec
from finetrainers_tpu.models.ltx_video import LTXVideoTransformer3DModel as JaxLTX
from finetrainers_tpu.models.modeling_utils import ModelHandle, flatten_params
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.models.autoencoders import AutoencoderConfig, load_flax_vae_params
from finetrainers_tpu_torch.models.ltx_video import LTXVideoModelSpecification, load_flax_params
from finetrainers_tpu_torch.processors import HashEncoder
from finetrainers_tpu_torch.schedulers import FlowMatchEulerScheduler
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=8,
            cross_attention_dim=16, num_layers=2, caption_channels=32)
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
              spatial_downsample=(True,), temporal_downsample=(True,))
REQUEST = dict(prompt="a red fox runs through fresh snow", height=16, width=16, num_frames=5,
               num_inference_steps=2, guidance_scale=3.0, seed=0)


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


def _port_pipeline(jax_transformer, jax_vae):
    spec = LTXVideoModelSpecification(transformer_config=TINY, vae_config=AutoencoderConfig(**VAE_KW),
                                      device="cpu", transformer_dtype=torch.float32, vae_dtype=torch.float32)
    transformer = spec.load_diffusion_models()["transformer"]
    load_flax_params(transformer.module, _flat(jax_transformer.params))
    vae = spec.load_latent_models()["vae"]
    load_flax_vae_params(vae.module, _flat(jax_vae.params))
    return spec.load_pipeline(transformer=transformer, vae=vae, text_encoder=HashEncoder(hidden_size=32, max_length=16))


def _jax_handles(spec):
    """The JAX spec's offline `load_diffusion_models` / `load_latent_models`
    (base_specification.py:100-137), with `init` drawn by `drawn_params` to keep CPU time down."""
    module = JaxLTX(**spec.transformer_config, dtype=spec.transformer_dtype)
    params = drawn_params(module, jnp.zeros((1, 8, 4)), jnp.zeros((1, 16, 32)),
                          jnp.zeros((1,)), num_frames=2, height=2, width=2)
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
    spec = JaxSpec(transformer_config=TINY, vae_config=JaxVAEConfig(**VAE_KW))
    spec.transformer_dtype = jnp.float32
    spec.vae_dtype = jnp.float32
    transformer, vae = _jax_handles(spec)
    jax_pipe = spec.load_pipeline(transformer=transformer, vae=vae,
                                  text_encoder=JaxHashEncoder(hidden_size=32, max_length=16))
    return jax_pipe, _port_pipeline(transformer, vae)


def test_t2v_video_matches_jax(pipelines):
    jax_pipe, port_pipe = pipelines
    ref = jax_pipe(**REQUEST)
    shape = port_pipe.latent_shape(REQUEST["num_frames"], REQUEST["height"], REQUEST["width"])
    draw = np.array(jax.random.normal(jax.random.PRNGKey(REQUEST["seed"]), shape, jnp.float32))
    video = port_pipe(**REQUEST, latents=torch.from_numpy(draw))
    assert video.shape == ref.shape == (5, 16, 16, 3) and video.dtype == np.uint8
    diff = np.abs(video.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_seeded_draw_is_reproducible(pipelines):
    _, port_pipe = pipelines
    request = {**REQUEST, "num_inference_steps": 1}
    np.testing.assert_array_equal(port_pipe(**request), port_pipe(**request))


def test_image_to_video_is_not_ported(pipelines):
    _, port_pipe = pipelines
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_pipe(**REQUEST, image=np.zeros((16, 16, 3), np.uint8))


@pytest.mark.parametrize("steps", [1, 2, 8, 50])
def test_sigma_grids_identical(steps):
    for shift in (1.0, 3.0):
        np.testing.assert_array_equal(FlowMatchEulerScheduler(shift=shift).inference_sigmas(steps),
                                      JaxScheduler(shift=shift).inference_sigmas(steps))


def test_hash_encoder_outputs_identical():
    captions = ["", "a red fox runs through fresh snow", "x " * 200]
    for hidden, length in ((32, 16), (4096, 128)):
        ref_e, ref_m = JaxHashEncoder(hidden_size=hidden, max_length=length).encode(captions)
        e, m = HashEncoder(hidden_size=hidden, max_length=length).encode(captions)
        np.testing.assert_array_equal(e, ref_e)
        np.testing.assert_array_equal(m, ref_m)


def test_prepare_conditions_identical(pipelines):
    jax_pipe, port_pipe = pipelines
    for caption in ("", "a fox"):
        ref = jax_pipe.spec.prepare_conditions(caption=caption, text_encoder=jax_pipe.text_encoder)
        out = port_pipe.spec.prepare_conditions(caption=caption, text_encoder=port_pipe.text_encoder)
        for key in ("encoder_hidden_states", "encoder_attention_mask"):
            np.testing.assert_array_equal(out[key], np.asarray(ref[key]))


def test_registry_resolves_ltx_and_refuses_unported_families():
    """LTX resolves; every family is ported (the dummy last), so the registry
    refuses only a training type a family lacks."""
    from finetrainers_tpu_torch.models.dummy import DummyModelSpecification

    assert get_model_specification_cls("ltx_video", "lora") is LTXVideoModelSpecification
    assert get_model_specification_cls("dummy", "lora") is DummyModelSpecification
    with pytest.raises(ValueError):
        get_model_specification_cls("ltx_video", "control-lora")
