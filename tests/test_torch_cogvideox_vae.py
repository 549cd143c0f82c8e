"""`AutoencoderKLCogVideoX` against JAX's at a tiny width with both temporal
stages (9 frames at 32x32 -> 3 latent frames at 4x4): its weights written to
a diffusers-named safetensors file by JAX's exporter
(`export_cogvideox_vae_state_dict`) and loaded by name into the port. Encode
and decode agree within 1e-5 relative L2 in fp32 (and 1e-4 elementwise: the
deep decoder's fp32 roundings reach 1.4e-5 at a few elements). The
SpatialNorm is also held alone at sizes whose resize ratios are no integers
(3 latent frames onto 4, 4x4 onto 6x6), where torch's "nearest" would read
other rows; and the frame-run path (past `SPLIT_ELEMENTS`) against the
single pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from finetrainers_tpu.models.cogvideox import vae as jax_vae
from finetrainers_tpu_torch.models import autoencoders, causal_vae
from finetrainers_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogSpatialNorm3D, CogVideoXVAEConfig
from finetrainers_tpu_torch.models.weight_utils import load_diffusers_checkpoint_dir, load_named_weights
from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)
TOL = 1e-5
ELEMENT_TOL = 1e-4
TINY = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
VIDEO, LATENTS = (1, 3, 9, 32, 32), (1, 4, 3, 4, 4)


def perturbed(params, seed):
    """Norm scales ~ 1 + N(0, 0.01) and biases ~ N(0, 0.01): off their init."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: p + (0.1 * rng.randn(*p.shape)).astype(p.dtype) if path[-1].key in ("scale", "bias") else p,
        params)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def vae(tmp_path_factory):
    """(JAX module, its params, the port loaded from the exporter's file, the file's state)."""
    module = jax_vae.AutoencoderKLCogVideoX(jax_vae.CogVideoXVAEConfig(**TINY), dtype=jnp.float32)
    params = perturbed(drawn_params(module, jnp.zeros(VIDEO, jnp.float32), seed=3), 3)
    path = tmp_path_factory.mktemp("cogvideox_vae")
    safetensors_save_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           jax_vae.export_cogvideox_vae_state_dict(params).items()},
                          str(path / "diffusion_pytorch_model.safetensors"))
    state = load_diffusers_checkpoint_dir(str(path))
    port = AutoencoderKLCogVideoX(CogVideoXVAEConfig(**TINY), torch.float32)
    assert load_named_weights(port, state) == ()  # every name of the file, and none left over
    return module, params, port.eval(), state


def _jax(module, method):
    return jax.jit(lambda p, x: module.apply({"params": p}, x, method=method))


def test_encode_and_decode_match_jax(vae):
    module, params, port, state = vae
    assert port.state_dict().keys() == state.keys()
    assert "decoder.up_blocks.0.resnets.0.norm1.conv_y.conv.weight" in state
    assert "encoder.down_blocks.2.resnets.0.conv_shortcut.weight" in state
    x = np.random.RandomState(1).uniform(-1, 1, VIDEO).astype(np.float32)
    want = np.asarray(_jax(module, type(module).encode)(params, x))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 8, *LATENTS[2:])
    assert rel_l2(got, want) <= TOL
    np.testing.assert_allclose(got, want, atol=ELEMENT_TOL, rtol=0)
    z = np.random.RandomState(2).randn(*LATENTS).astype(np.float32)
    want = np.asarray(_jax(module, type(module).decode)(params, z))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == VIDEO
    assert rel_l2(got, want) <= TOL
    np.testing.assert_allclose(got, want, atol=ELEMENT_TOL, rtol=0)


def test_spatial_norm_resizes_half_pixel_at_ratios_that_are_no_integers():
    """f has 4 frames of 6x6 and zq 3 of 4x4: frames 1.. of zq (2) go onto 3
    and 4 rows onto 6, ratios 1.5, where half-pixel nearest and torch's
    "nearest" read different rows."""
    jax_norm = jax_vae.CogSpatialNorm3D(8, 4, 4)
    f = np.random.RandomState(4).randn(1, 4, 6, 6, 8).astype(np.float32)  # NDHWC, as JAX runs
    zq = np.random.RandomState(5).randn(1, 3, 4, 4, 4).astype(np.float32)
    params = perturbed(drawn_params(jax_norm, f, zq, seed=6), 6)
    want = np.asarray(jax.jit(lambda p: jax_norm.apply({"params": p}, f, zq))(params)).transpose(0, 4, 1, 2, 3)
    port = CogSpatialNorm3D(8, 4, 4, torch.float32)
    state = {"norm_layer.weight": params["norm_layer"]["scale"], "norm_layer.bias": params["norm_layer"]["bias"]}
    for name in ("conv_y", "conv_b"):
        state[f"{name}.conv.weight"] = np.asarray(params[name]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2)
        state[f"{name}.conv.bias"] = params[name]["conv"]["bias"]
    load_named_weights(port, {k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    f_t, zq_t = (torch.from_numpy(a.transpose(0, 4, 1, 2, 3).copy()) for a in (f, zq))
    with torch.no_grad():
        got = port(f_t, zq_t).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert causal_vae.nearest_indices(4, 6, torch.device("cpu")).tolist() == [0, 1, 1, 2, 3, 3]
    assert F.interpolate(torch.arange(4.0)[None, None], size=6, mode="nearest")[0, 0].tolist() != [0, 1, 1, 2, 3, 3]


def test_frame_runs_match_the_single_pass(vae, monkeypatch):
    """Past SPLIT_ELEMENTS the convs, norms, SpatialNorms, resamplers run in
    runs of frames; the encode and decode equal the single pass."""
    port = vae[2]
    x = torch.from_numpy(np.random.RandomState(7).uniform(-1, 1, VIDEO).astype(np.float32))
    z = torch.from_numpy(np.random.RandomState(8).randn(*LATENTS).astype(np.float32))
    with torch.no_grad():
        whole = port.encode(x), port.decode(z)
        runs = []
        step = causal_vae.frame_step
        monkeypatch.setattr(autoencoders, "SPLIT_ELEMENTS", 4000)
        monkeypatch.setattr(causal_vae, "frame_step", lambda n, e: runs.append(step(n, e) < n) or step(n, e))
        import finetrainers_tpu_torch.models.cogvideox.vae as cog

        monkeypatch.setattr(cog, "frame_step", causal_vae.frame_step)
        split = port.encode(x), port.decode(z)
    assert sum(runs) > 10
    for a, b in zip(whole, split):
        assert rel_l2(b.numpy(), a.numpy()) <= TOL
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ELEMENT_TOL, rtol=0)
