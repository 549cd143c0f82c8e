"""`AutoencoderKLHunyuanVideo` against JAX's at a tiny width with both
temporal stages (9 frames at 32x32 -> 3 latent frames at 4x4, the mid blocks'
attention over 48 latent tokens): its weights written to a diffusers-named
safetensors file by JAX's exporter (`export_hunyuan_vae_state_dict`) and
loaded by name into the port. Encode and decode agree within 1e-5 relative L2
in fp32 (and 1e-4 elementwise). The frame-run path (past `SPLIT_ELEMENTS`) and
the attention in several chunks of query rows (`ATTENTION_SCORE_ELEMENTS`)
each equal the single pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.hunyuan_video import vae as jax_vae
from finetrainers_tpu_torch.models import autoencoders, causal_vae
from finetrainers_tpu_torch.models.hunyuan_video import vae as port_vae
from finetrainers_tpu_torch.models.weight_utils import load_diffusers_checkpoint_dir, load_named_weights
from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict
from test_torch_cogvideox_vae import ELEMENT_TOL, TOL, perturbed, rel_l2
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)
TINY = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
VIDEO, LATENTS = (1, 3, 9, 32, 32), (1, 4, 3, 4, 4)


@pytest.fixture(scope="module")
def vae(tmp_path_factory):
    """(JAX module, its params, the port loaded from the exporter's file, the file's state)."""
    module = jax_vae.AutoencoderKLHunyuanVideo(jax_vae.HunyuanVAEConfig(**TINY), dtype=jnp.float32)
    params = perturbed(drawn_params(module, jnp.zeros(VIDEO, jnp.float32), seed=9), 9)
    path = tmp_path_factory.mktemp("hunyuan_vae")
    safetensors_save_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           jax_vae.export_hunyuan_vae_state_dict(params).items()},
                          str(path / "diffusion_pytorch_model.safetensors"))
    state = load_diffusers_checkpoint_dir(str(path))
    port = port_vae.AutoencoderKLHunyuanVideo(port_vae.HunyuanVAEConfig(**TINY), torch.float32)
    assert load_named_weights(port, state) == ()  # every name of the file, and none left over
    return module, params, port.eval(), state


def _jax(module, method):
    return jax.jit(lambda p, x: module.apply({"params": p}, x, method=method))


def test_encode_and_decode_match_jax(vae):
    module, params, port, state = vae
    assert port.state_dict().keys() == state.keys()
    for name in ("encoder.mid_block.attentions.0.to_out.0.weight",
                 "encoder.down_blocks.1.downsamplers.0.conv.conv.weight",
                 "decoder.up_blocks.1.upsamplers.0.conv.conv.weight", "quant_conv.weight",
                 "encoder.down_blocks.2.resnets.0.conv_shortcut.conv.weight"):
        assert name in state, name
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


@pytest.mark.parametrize("split", ["frame_runs", "attention_chunks"])
def test_split_paths_match_the_single_pass(vae, monkeypatch, split):
    """Past SPLIT_ELEMENTS the convs (the upsamplers' reading only their runs'
    frames) and norms run in runs of frames; at 5 query rows a chunk the mid
    blocks' attention over 48 tokens takes 10 chunks. Each equals the single pass."""
    port = vae[2]
    x = torch.from_numpy(np.random.RandomState(7).uniform(-1, 1, VIDEO).astype(np.float32))
    z = torch.from_numpy(np.random.RandomState(8).randn(*LATENTS).astype(np.float32))
    with torch.no_grad():
        whole = port.encode(x), port.decode(z)
        seen = []
        if split == "frame_runs":
            step = causal_vae.frame_step
            monkeypatch.setattr(autoencoders, "SPLIT_ELEMENTS", 4000)
            monkeypatch.setattr(causal_vae, "frame_step", lambda n, e: seen.append(step(n, e) < n) or step(n, e))
        else:
            monkeypatch.setattr(port_vae, "ATTENTION_SCORE_ELEMENTS", 5 * 48)
            softmax = torch.softmax
            monkeypatch.setattr(torch, "softmax", lambda s, dim: seen.append(s.shape[1]) or softmax(s, dim=dim))
        parts = port.encode(x), port.decode(z)
    if split == "frame_runs":
        assert sum(seen) > 10
    else:  # the encoder's and the decoder's attention, 48 rows each in chunks of 5
        assert seen == 2 * ([5] * 9 + [3])
    for a, b in zip(whole, parts):
        assert rel_l2(b.numpy(), a.numpy()) <= TOL
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ELEMENT_TOL, rtol=0)
