"""The generic VAE's split pass for large activations (`autoencoders.SPLIT_ELEMENTS`).

At 81x480x832 the Wan config's full-resolution activations hold 3.1e9
elements; past SPLIT_ELEMENTS a causal conv runs in strips of output rows
(with its halo, the decoder's upsampling done per strip) and a GroupNorm in
runs of frames. The tests lower the threshold so that a tiny VAE takes the
split at every stage, and hold its encode and decode bit-equal to the whole
pass on the same CPU (each output element is the same sum over the same
inputs), at sizes whose rows and frames do not divide evenly, with the
spatial and temporal strides of `WAN_VAE_CONFIG`. A strip reads only its own
rows: the split pass equals JAX's encode and decode within the tolerance of
the whole pass's parity tests (atol 1e-4, fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.layers import init_parameters_
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

# WAN_VAE_CONFIG's strides (8x spatial, 4x temporal) at 4-8 channels.
CONFIG = dict(latent_channels=4, block_out_channels=(4, 8, 8, 8), layers_per_block=1,
              spatial_downsample=(True, True, True), temporal_downsample=(False, True, True))


@pytest.fixture(scope="module")
def vae():
    module = autoencoders.AutoencoderKL3D(autoencoders.AutoencoderConfig(**CONFIG), dtype=torch.float32)
    return init_parameters_(module, torch.Generator().manual_seed(0)).eval()


def _count_strips(monkeypatch):
    calls = {"rows": 0, "frames": 0}
    rows, frames = autoencoders.CausalConv3d._rows, autoencoders.GroupNorm._frames

    def count_rows(self, *args, **kwargs):
        calls["rows"] += 1
        return rows(self, *args, **kwargs)

    def count_frames(self, *args, **kwargs):
        calls["frames"] += 1
        return frames(self, *args, **kwargs)

    monkeypatch.setattr(autoencoders.CausalConv3d, "_rows", count_rows)
    monkeypatch.setattr(autoencoders.GroupNorm, "_frames", count_frames)
    return calls


@pytest.mark.parametrize("shape", [(1, 3, 9, 40, 56), (2, 3, 5, 24, 32), (1, 3, 1, 16, 24)],
                         ids=["9x40x56", "batch2_5x24x32", "one_frame"])
def test_split_pass_equals_the_whole_pass(vae, shape, monkeypatch):
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32))
    with torch.no_grad():
        moments = vae.encode(x)
        video = vae.decode(moments[:, :4])
        calls = _count_strips(monkeypatch)
        monkeypatch.setattr(autoencoders, "SPLIT_ELEMENTS", 700)
        split_moments = vae.encode(x)
        split_video = vae.decode(moments[:, :4])
    assert calls["rows"] > 50 and calls["frames"] > 10, calls
    assert video.shape == (shape[0], 3, shape[2], *shape[3:])
    assert torch.equal(split_moments, moments)
    assert torch.equal(split_video, video)


def test_strips_of_one_row_and_norms_of_one_frame(vae, monkeypatch):
    """At a threshold of one element every conv runs one output row at a time
    and every norm one frame at a time: still the whole pass."""
    x = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (1, 3, 5, 16, 24)).astype(np.float32))
    with torch.no_grad():
        moments, video = vae.encode(x), vae.decode(vae.encode(x)[:, :4])
        monkeypatch.setattr(autoencoders, "SPLIT_ELEMENTS", 1)
        assert torch.equal(vae.encode(x), moments)
        assert torch.equal(vae.decode(moments[:, :4]), video)


def test_split_pass_matches_jax(monkeypatch):
    module = jax_ae.AutoencoderKL3D(jax_ae.AutoencoderConfig(**CONFIG), dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 3, 1, 8, 8)))
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}
    port = autoencoders.load_flax_vae_params(
        autoencoders.AutoencoderKL3D(autoencoders.AutoencoderConfig(**CONFIG), dtype=torch.float32), flat).eval()
    x = np.random.RandomState(3).uniform(-1, 1, (1, 3, 5, 24, 32)).astype(np.float32)
    encode = jax.jit(lambda p, v: module.apply({"params": p}, v, method=jax_ae.AutoencoderKL3D.encode))
    decode = jax.jit(lambda p, z: module.apply({"params": p}, z, method=jax_ae.AutoencoderKL3D.decode))
    ref_moments = np.asarray(encode(params, jnp.asarray(x)))
    ref_video = np.asarray(decode(params, jnp.asarray(ref_moments[:, :4])))
    monkeypatch.setattr(autoencoders, "SPLIT_ELEMENTS", 500)
    with torch.no_grad():
        moments = port.encode(torch.from_numpy(x))
        video = port.decode(torch.from_numpy(np.array(ref_moments[:, :4])))
    np.testing.assert_allclose(moments.numpy(), ref_moments, atol=1e-4, rtol=0)
    np.testing.assert_allclose(video.numpy(), ref_video, atol=1e-4, rtol=0)
