"""The faithful video VAEs against JAX's: `AutoencoderKLWan` and
`AutoencoderKLLTXVideo` at tiny widths, their weights written to a
diffusers-named safetensors file by JAX's exporters (`export_wan_vae_state_dict`,
`export_ltx_vae_state_dict`) and loaded by name into the port. Encode and
decode agree within 1e-5 in fp32 (JAX's side jitted once per module). The
Wan encoder is also run with an attention block in its down path, and its
frame-run path (past `SPLIT_ELEMENTS`) against its single pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.ltx_video import vae as jax_ltx
from finetrainers_tpu.models.wan import vae as jax_wan
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.ltx_video.vae import AutoencoderKLLTXVideo, LTXVAEConfig
from finetrainers_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
from finetrainers_tpu_torch.models.weight_utils import load_diffusers_checkpoint_dir, load_named_weights
from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict

torch.set_num_threads(1)
TOL = 1e-5
WAN = dict(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1, temperal_downsample=(False, True))
LTX = dict(latent_channels=4, block_out_channels=(8, 16), decoder_block_out_channels=(8, 16),
           layers_per_block=(1, 1, 1), decoder_layers_per_block=(1, 1, 1), spatio_temporal_scaling=(True, False),
           decoder_spatio_temporal_scaling=(True, False), patch_size=2)
# name: (JAX module, JAX config, exporter, port module, port config, input (B, C, T, H, W), latents)
FAMILIES = {
    "wan": (jax_wan.AutoencoderKLWan, jax_wan.WanVAEConfig(**WAN), jax_wan.export_wan_vae_state_dict,
            AutoencoderKLWan, WanVAEConfig(**WAN), (1, 3, 5, 16, 24), (1, 4, 3, 4, 6)),
    "wan_attn": (jax_wan.AutoencoderKLWan, jax_wan.WanVAEConfig(**WAN, attn_scales=(0.5,)),
                 jax_wan.export_wan_vae_state_dict, AutoencoderKLWan, WanVAEConfig(**WAN, attn_scales=(0.5,)),
                 (1, 3, 5, 16, 24), (1, 4, 3, 4, 6)),
    "ltx": (jax_ltx.AutoencoderKLLTXVideo, jax_ltx.LTXVAEConfig(**LTX), jax_ltx.export_ltx_vae_state_dict,
            AutoencoderKLLTXVideo, LTXVAEConfig(**LTX), (1, 3, 5, 16, 16), (1, 4, 3, 4, 4)),
}


@pytest.fixture(scope="module")
def vaes(tmp_path_factory):
    """{name: (JAX module, perturbed params, port module loaded from the file, the file's state)}."""
    out = {}
    for name, (jax_cls, jax_cfg, export, port_cls, port_cfg, shape, _) in FAMILIES.items():
        module = jax_cls(jax_cfg, dtype=jnp.float32)
        x = jnp.zeros(shape, jnp.float32)
        params = _perturb(drawn_params(module, x, seed=len(out)), len(out))
        path = tmp_path_factory.mktemp(name)
        safetensors_save_dict({k: torch.from_numpy(np.array(v)) for k, v in export(params).items()},
                              str(path / "diffusion_pytorch_model.safetensors"))
        state = load_diffusers_checkpoint_dir(str(path))
        port = port_cls(port_cfg, torch.float32)
        assert load_named_weights(port, state) == ()  # every name of the file, and none left over
        out[name] = (module, params, port.eval(), state)
    return out


def drawn_params(module, *args, seed=0, **kwargs):
    """The parameter tree `module.init(PRNGKey(seed), *args, **kwargs)["params"]`
    would give, its names and shapes from `jax.eval_shape` (no XLA compile of
    the init, which costs seconds a model on the CPU), drawn in numpy from
    `seed` at flax's scales: kernels ~ N(0, 1/fan_in) (fan_in without a
    scanned stack's leading axis), LoRA A ~ N(0, 1/r), LoRA B and biases 0,
    norm scales and gammas 1, every other table ~ N(0, 0.02)."""
    abstract = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(seed), *args, **kwargs)["params"])
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        fan_shape = shape[1:] if any("_scan" in str(getattr(k, "key", "")) for k in path) else shape
        if name == "kernel":
            value = rng.randn(*shape) * np.prod(fan_shape[:-1]) ** -0.5
        elif name == "lora_a":
            value = rng.randn(*shape) / fan_shape[-1]
        elif name in ("lora_b", "bias"):
            value = np.zeros(shape)
        elif name in ("scale", "gamma"):
            value = np.ones(shape)
        else:
            value = rng.randn(*shape) * 0.02
        return value.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, abstract)


def _perturb(params, seed):
    """Gammas ~ 1 + N(0, 0.01), biases ~ N(0, 0.01): norms and biases off their init."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: p + (0.1 * rng.randn(*p.shape)).astype(p.dtype) if path[-1].key in ("gamma", "bias") else p,
        params)


def _jax(module, method):
    return jax.jit(lambda p, x: module.apply({"params": p}, x, method=method))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_encode_and_decode_match_jax(vaes, name):
    module, params, port, state = vaes[name]
    shape, latent_shape = FAMILIES[name][5], FAMILIES[name][6]
    assert port.state_dict().keys() == state.keys()
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(_jax(module, type(module).encode)(params, x))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2 * latent_shape[1], *latent_shape[2:])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if name == "ltx":  # the shared log-variance channel
        assert np.array_equal(got[:, 4:5].repeat(4, axis=1), got[:, 4:])
    z = np.random.RandomState(2).randn(*latent_shape).astype(np.float32)
    want = np.asarray(_jax(module, type(module).decode)(params, z))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape and got.shape[1] == 3 and got.shape[2] == shape[2]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wan_frame_runs_match_the_single_pass(vaes, monkeypatch):
    """Past SPLIT_ELEMENTS the causal convs, norms and per-frame 2D ops run in
    runs of frames; the encode and decode equal the single pass."""
    _, _, port, _ = vaes["wan"]
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (1, 3, 9, 16, 24)).astype(np.float32))
    z = torch.from_numpy(np.random.RandomState(4).randn(1, 4, 3, 4, 6).astype(np.float32))
    with torch.no_grad():
        whole = port.encode(x), port.decode(z)
        monkeypatch.setattr(autoencoders, "SPLIT_ELEMENTS", 600)
        import finetrainers_tpu_torch.models.wan.vae as wan_vae

        calls = []
        pieces = wan_vae._pieces
        monkeypatch.setattr(wan_vae, "_pieces", lambda size, n: calls.append(n) or max(1, size * 600 // n))
        runs = port.encode(x), port.decode(z)
    assert max(calls) > 600 and pieces(9, 10) == 9
    for a, b in zip(whole, runs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL, rtol=TOL)
