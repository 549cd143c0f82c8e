"""VAE parity: JAX `AutoencoderKL3D.encode` / `decode` against the port.

A tiny 2-stage config (the LTX tests' TINY_VAE, with a spatial and a temporal
downsample), fp32, weights carried across by `load_flax_vae_params`; atol 1e-4
(fp32 convolutions and GroupNorm statistics summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.autoencoders import AutoencoderKL3D as JaxVAE
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu_torch.models.autoencoders import (
    LTX_VAE_CONFIG,
    AutoencoderConfig,
    AutoencoderKL3D,
    load_flax_vae_params,
)
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

TINY_VAE = AutoencoderConfig(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
                             spatial_downsample=(True,), temporal_downsample=(True,))


@pytest.fixture(scope="module")
def vaes():
    jax_vae = JaxVAE(TINY_VAE, dtype=jnp.float32)
    params = drawn_params(jax_vae, jnp.zeros((1, 3, 1, 2, 2)))
    rng = np.random.RandomState(5)
    flat = {}
    for key, value in flatten_params(jax.device_get(params)).items():
        value = np.asarray(value)
        if key.endswith("bias") or key.endswith("scale"):  # make norms and biases non-trivial
            value = value + 0.1 * rng.randn(*value.shape).astype(np.float32)
        flat[key] = value
    port = load_flax_vae_params(AutoencoderKL3D(TINY_VAE, dtype=torch.float32), flat)
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return jax_vae, tree, port


@pytest.mark.parametrize("shape", [(1, 3, 5, 8, 8), (2, 3, 3, 7, 9)], ids=["even", "odd_spatial"])
def test_encode_matches_jax(vaes, shape):
    jax_vae, params, port = vaes
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    ref = jax.jit(lambda p, x: jax_vae.apply({"params": p}, x, method=JaxVAE.encode))(params, jnp.asarray(x))
    with torch.no_grad():
        out = port.encode(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_decode_matches_jax(vaes):
    jax_vae, params, port = vaes
    z = np.random.RandomState(2).randn(1, 4, 3, 4, 4).astype(np.float32)
    ref = jax.jit(lambda p, z: jax_vae.apply({"params": p}, z, method=JaxVAE.decode))(params, jnp.asarray(z))
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z))
    assert tuple(out.shape) == ref.shape == (1, 3, 5, 8, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_ltx_vae_decode_shape_matches_jax():
    """LTX_VAE_CONFIG has five spatial flags, but the decoder uses four, so a
    7x16x24 latent (a 49x512x768 request) decodes to 49x256x384 in both
    packages. The port matches the reference; the finding is in ROADMAP.md."""
    with torch.device("meta"):
        vae = AutoencoderKL3D(LTX_VAE_CONFIG)
        out = vae.decode(torch.empty(1, 128, 7, 16, 24))
    assert tuple(out.shape) == (1, 3, 49, 256, 384)
