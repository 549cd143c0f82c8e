"""Encoding media: the port's `encode_media` and the specs' `prepare_latents`
and `collate_latents` against the JAX package's.

A small generic VAE with the Wan VAE's 8x spatial and 4x temporal compression
(4-8 channels), fp32, its JAX weights carried across by
`load_flax_vae_params` (norms and biases made non-trivial). Seeded media in
[-1, 1] go through both packages plain, batch-sliced (`enable_slicing`, B=2)
and spatially tiled (`enable_tiling`; the tile and overlap cut from 256 and 32
pixels to 32 and 8 to keep the CPU run short, the same code path, so
overlapping tiles' moments are averaged in both directions): atol 1e-4 (fp32
convolutions summed in another order). `prepare_latents` of the
Wan and LTX specs turn a (T, C, H, W) video and a (C, H, W) image into the same
moments and statistics as JAX's, and the collated batch matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.ltx_video import LTXVideoModelSpecification as JaxLTX
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.wan import WanModelSpecification as JaxWan
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.modeling_utils import ModelHandle
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

ATOL = 1e-4
VAE = autoencoders.AutoencoderConfig(latent_channels=4, block_out_channels=(4, 8, 8, 8), layers_per_block=1,
                                     spatial_downsample=(True, True, True), temporal_downsample=(False, True, True))


@pytest.fixture(scope="module")
def vaes():
    module = jax_ae.AutoencoderKL3D(VAE, dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 3, 1, 8, 8)))
    rng = np.random.RandomState(5)
    flat = {}
    for key, value in flatten_params(jax.device_get(params)).items():
        value = np.asarray(value)
        if key.endswith(("bias", "scale")):
            value = value + 0.1 * rng.randn(*value.shape).astype(np.float32)
        flat[key] = value
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    config = {"latent_channels": 4, "spatial_compression_ratio": 8, "temporal_compression_ratio": 4,
              "latents_mean": (0.1 * rng.randn(4)).astype(np.float32),
              "latents_std": (1 + 0.1 * rng.rand(4)).astype(np.float32)}
    port = autoencoders.load_flax_vae_params(autoencoders.AutoencoderKL3D(VAE, dtype=torch.float32), flat).eval()
    return _JittedHandle(module, tree, dict(config)), ModelHandle(port, dict(config))


_encode = jax.jit(lambda module, params, x: module.apply({"params": params}, x, method=jax_ae.AutoencoderKL3D.encode),
                  static_argnums=0)


class _JittedHandle(JaxHandle):
    """The JAX handle with its encode jitted (one compile per input shape
    instead of one per operation)."""

    def apply(self, x, method=None):
        assert method is jax_ae.AutoencoderKL3D.encode
        return _encode(self.module, self.params, x)


def _modes(handles, slicing, tiling):
    jax_handle, port = handles
    jax_handle.use_slicing, jax_handle.use_tiling = slicing, tiling
    port.use_slicing, port.use_tiling = slicing, tiling
    return jax_handle, port


TILE = dict(tile=32, overlap=8)


@pytest.mark.parametrize("slicing,tiling,shape", [
    (False, False, (1, 3, 5, 32, 40)),
    (True, False, (2, 3, 5, 32, 40)),
    (False, True, (1, 3, 5, 40, 56)),
    (True, True, (2, 3, 5, 56, 32)),
], ids=["plain", "sliced", "tiled", "sliced_and_tiled"])
def test_encode_media_matches_jax(vaes, slicing, tiling, shape):
    jax_handle, port = _modes(vaes, slicing, tiling)
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    ref = np.asarray(jax_ae.encode_media(jax_handle, jnp.asarray(x), **TILE))
    out = autoencoders.encode_media(port, torch.from_numpy(x), **TILE)
    assert out.dtype == torch.float32 and not out.requires_grad and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    if tiling:  # the tiles are averaged where they overlap: not the plain encode
        port.use_tiling = False
        assert not np.allclose(autoencoders.encode_media(port, torch.from_numpy(x), **TILE).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("family", ["wan", "ltx_video"])
def test_prepare_and_collate_latents_match_jax(vaes, family):
    jax_handle, port = _modes(vaes, False, True)
    spec = get_model_specification_cls(family, "lora")(device="cpu")
    jax_spec = (JaxWan if family == "wan" else JaxLTX)()
    rng = np.random.RandomState(2)
    video = rng.uniform(-1, 1, (5, 3, 16, 24)).astype(np.float32)
    image = rng.uniform(-1, 1, (3, 16, 24)).astype(np.float32)
    items = []
    for media in ({"video": video}, {"image": image}):
        ours = spec.prepare_latents(vae=port, **media)
        ref = jax_spec.prepare_latents(vae=jax_handle, **media)
        assert ours.keys() == ref.keys()
        np.testing.assert_allclose(ours["latents"].numpy(), np.asarray(ref["latents"]), atol=ATOL, rtol=0)
        for key in ("latents_mean", "latents_std"):
            assert np.array_equal(ours[key], ref[key])
        items.append((ours, ref))
    with pytest.raises(NotImplementedError):
        spec.prepare_latents(vae=port, image=image, compute_posterior=True)
    video_item = items[0]
    ours, ref = spec.collate_latents([video_item[0]] * 2), jax_spec.collate_latents([video_item[1]] * 2)
    assert ours.keys() == ref.keys() and ours["latents"].shape == ref["latents"].shape == (2, 8, 2, 2, 3)
    for key in ("latents_mean", "latents_std"):
        assert np.array_equal(ours[key], ref[key]) and ours[key].shape == (4,)
    conditions = [spec.prepare_conditions(caption=c, text_encoder=spec.load_condition_models()["text_encoder"])
                  for c in ("a cat", "a dog on a hill")]
    ours = spec.collate_conditions(conditions)
    ref = jax_spec.collate_conditions(conditions)
    assert all(np.array_equal(ours[k], ref[k]) for k in ref)
    assert spec._resolution_dim_keys == jax_spec._resolution_dim_keys
