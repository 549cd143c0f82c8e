"""The Flux serving slice as a whole: JAX `FluxPipeline` and the JAX runner
(`examples/inference/inference.py --model_name flux --inference_type
text_to_image`) against the port's.

Both packages build the tiny Flux spec in fp32 (2 dual and 2 single blocks, 2
heads of 64, a VAE of 8-16 channels with one 2x spatial stage and no temporal
one) with `HashEncoder` in both text slots (512 text tokens, a few valid),
guidance 3.5 embedded and 2 flow-match Euler steps shifted by `_flux_shift_mu`.
The port gets JAX's transformer and VAE weights through the bridge and JAX's
initial draw `jax.random.normal(PRNGKey(seed), shape)` as `latents=`. The
final latents before the VAE agree at atol 1e-3 and the uint8 images within
1 level (fp32 sums in another order can move a value across a rounding
boundary of the final `* 255` cast). `_flux_shift_mu` and the sigma grid are
exact. The runner writes one .png, as JAX's does. The T5 slot's quirk (both
slots encoded by the pipeline's one encoder) is pinned on both sides.
"""

import functools
import importlib.util
import json
import pathlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import finetrainers_tpu.config as jax_config
from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.flux import FluxModelSpecification as JaxSpec
from finetrainers_tpu.models.flux import FluxTransformer2DModel as JaxFlux
from finetrainers_tpu.models.flux.pipeline import FluxPipeline as JaxFluxPipeline
from finetrainers_tpu.models.flux.pipeline import _flux_shift_mu as jax_shift_mu
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls, inference
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.flux import FluxModelSpecification, FluxPipeline, load_flax_params
from finetrainers_tpu_torch.models.flux import pipeline as flux_pipeline
from finetrainers_tpu_torch.models.flux.pipeline import _flux_shift_mu
from finetrainers_tpu_torch.processors import HashEncoder
from finetrainers_tpu_torch.schedulers import FlowMatchEulerScheduler
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
_runner_spec = importlib.util.spec_from_file_location("jax_inference_runner_flux",
                                                      REPO_ROOT / "examples/inference/inference.py")
jax_runner = importlib.util.module_from_spec(_runner_spec)
_runner_spec.loader.exec_module(jax_runner)

TINY = dict(in_channels=16, num_layers=2, num_single_layers=2, num_attention_heads=2, attention_head_dim=64,
            pooled_projection_dim=24, joint_attention_dim=32, guidance_embeds=True, axes_dims_rope=(16, 24, 24))
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, spatial_downsample=(True,),
              temporal_downsample=(False,))
REQUEST = dict(prompt="a trtcrd of a fox holding a lantern, tarot style", height=16, width=24,
               num_inference_steps=2, guidance_scale=3.5, seed=0)
LATENT_ATOL = 1e-3


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


@functools.lru_cache(maxsize=None)
def _jax_weights():
    """The tiny transformer's and VAE's JAX inits (`drawn_params`: eager flax init costs tens of seconds, a
    jitted one a compile)."""
    module = JaxFlux(**TINY, dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 4, 16)), jnp.zeros((1, 8, 32)),
                          jnp.zeros((1, 24)), jnp.zeros((1,)), jnp.zeros((4, 3)),
                          jnp.zeros((8, 3)))
    vae_module = jax_ae.AutoencoderKL3D(jax_ae.AutoencoderConfig(**VAE_KW), dtype=jnp.float32)
    vae_params = drawn_params(vae_module, jnp.zeros((1, 3, 1, 2, 2)))
    return module, params, vae_module, vae_params


def _jax_handles():
    """JAX's offline `load_diffusion_models` / `load_latent_models` (:105-141) with the inits above."""
    module, params, vae_module, vae_params = _jax_weights()
    transformer = JaxHandle(module, params, dict(TINY))
    vae = JaxHandle(vae_module, vae_params, {"latent_channels": 4, "spatial_compression_ratio": 2,
                                             "scaling_factor": 0.3611, "shift_factor": 0.1159})
    return transformer, vae


def _port_spec(**kwargs):
    return FluxModelSpecification(transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW),
                                  device="cpu", transformer_dtype=torch.float32, vae_dtype=torch.float32, **kwargs)


def _bridge_transformer(module):
    load_flax_params(module, _flat(_jax_weights()[1]))


def _bridge_vae(module):
    autoencoders.load_flax_vae_params(module, _flat(_jax_weights()[3]))


def _draw(height, width, seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, height // 2, width // 2), jnp.float32))


@pytest.fixture
def record_latents(monkeypatch):
    """The latents each package hands its VAE decode, by side."""
    seen = {}
    jax_decode, port_decode = jax_ae.decode_image_vae, flux_pipeline.decode_image_vae

    def jax_side(vae, z):
        seen["jax"] = np.asarray(z)
        return jax_decode(vae, z)

    def port_side(vae, z):
        seen["port"] = z.numpy().copy()
        return port_decode(vae, z)

    monkeypatch.setattr(jax_ae, "decode_image_vae", jax_side)
    monkeypatch.setattr(flux_pipeline, "decode_image_vae", port_side)
    return seen


def _assert_images_agree(ref, image, shape=(16, 24, 3)):
    assert image.shape == ref.shape == shape and image.dtype == np.uint8
    assert np.abs(image.astype(np.int16) - ref.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("seq_len", [1, 24, 256, 3600, 4096, 4608])
def test_shift_mu_and_sigma_grid_match_jax_exactly(seq_len):
    assert _flux_shift_mu(seq_len) == jax_shift_mu(seq_len)
    for steps in (2, 28):
        got = FlowMatchEulerScheduler().inference_sigmas(steps, mu=_flux_shift_mu(seq_len))
        ref = JaxScheduler().inference_sigmas(steps, mu=jax_shift_mu(seq_len))
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_text_to_image_matches_jax(record_latents):
    transformer, vae = _jax_handles()
    spec = JaxSpec(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW))
    spec.transformer_dtype = spec.vae_dtype = jnp.float32
    jax_pipe = spec.load_pipeline(transformer=transformer, vae=vae,
                                  text_encoder=JaxHashEncoder(hidden_size=32, max_length=16, pooled_dim=24))
    ref = jax_pipe(**REQUEST)
    port_spec = _port_spec()
    port_transformer = port_spec.load_diffusion_models()["transformer"]
    port_vae = port_spec.load_latent_models()["vae"]
    _bridge_transformer(port_transformer.module)
    _bridge_vae(port_vae.module)
    pipe = port_spec.load_pipeline(transformer=port_transformer, vae=port_vae,
                                   text_encoder=HashEncoder(hidden_size=32, max_length=16, pooled_dim=24))
    assert isinstance(pipe, FluxPipeline) and pipe.latent_shape(16, 24) == (1, 4, 8, 12)
    image = pipe(**REQUEST, latents=torch.from_numpy(_draw(16, 24, REQUEST["seed"])))
    np.testing.assert_allclose(record_latents["port"], record_latents["jax"], atol=LATENT_ATOL, rtol=0)
    _assert_images_agree(ref, image)
    # Without an explicit draw the seeded generator's, reproducibly.
    request = {**REQUEST, "num_inference_steps": 1}
    np.testing.assert_array_equal(pipe(**request), pipe(**request))


class _TinyJaxFlux(JaxSpec):
    """JAX's Flux spec at the tiny config, in fp32, with the inits above (the runner passes no config)."""

    def __init__(self, **kwargs):
        kwargs.pop("transformer_dtype", None), kwargs.pop("vae_dtype", None)
        super().__init__(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW), **kwargs)
        self.transformer_dtype = self.vae_dtype = jnp.float32

    def load_diffusion_models(self):
        return {"transformer": _jax_handles()[0], "scheduler": JaxScheduler(use_dynamic_shifting=True)}

    def load_latent_models(self):
        return {"vae": _jax_handles()[1]}


def test_text_to_image_through_main_matches_jax_runner(tmp_path, monkeypatch, record_latents):
    """`inference.main --model_name flux --inference_type text_to_image --device
    cpu` against the JAX runner, with a scheduler config written as the public
    FLUX.1-dev checkpoint names it: the same image, one .png each and a manifest."""
    ckpt = tmp_path / "ckpt"
    (ckpt / "scheduler").mkdir(parents=True)
    (ckpt / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", "num_train_timesteps": 1000, "shift": 3.0,
         "use_dynamic_shifting": True, "base_shift": 0.5, "max_shift": 1.15, "base_image_seq_len": 256,
         "max_image_seq_len": 4096}))
    argv = ["--model_name", "flux", "--pretrained_model_name_or_path", str(ckpt), "--inference_type",
            "text_to_image", "--prompt", REQUEST["prompt"], "--height", "16", "--width", "24",
            "--num_inference_steps", "2", "--guidance_scale", "3.5", "--seed", "4", "--transformer_dtype", "fp32",
            "--vae_dtype", "fp32"]
    images = {}
    jax_call, port_call = JaxFluxPipeline.__call__, FluxPipeline.__call__
    port_load_diffusion, port_load_latent = FluxModelSpecification.load_diffusion_models, \
        FluxModelSpecification.load_latent_models

    def jax_pipeline_call(self, **kwargs):
        images["jax"] = jax_call(self, **kwargs)
        return images["jax"]

    def port_pipeline_call(self, **kwargs):
        assert isinstance(self.scheduler, FlowMatchEulerScheduler) and self.scheduler.use_dynamic_shifting
        assert "num_frames" not in kwargs and kwargs["guidance_scale"] == 3.5
        images["port"] = port_call(self, **kwargs, latents=torch.from_numpy(_draw(16, 24, kwargs["seed"])))
        return images["port"]

    def port_diffusion(self):
        out = port_load_diffusion(self)
        _bridge_transformer(out["transformer"].module)
        return out

    def port_latent(self):
        out = port_load_latent(self)
        _bridge_vae(out["vae"].module)
        return out

    monkeypatch.setattr(jax_config, "_get_model_specifiction_cls", lambda name, training_type: _TinyJaxFlux)
    monkeypatch.setattr(JaxFluxPipeline, "__call__", jax_pipeline_call)
    monkeypatch.setattr(FluxPipeline, "__call__", port_pipeline_call)
    monkeypatch.setattr(FluxModelSpecification, "load_diffusion_models", port_diffusion)
    monkeypatch.setattr(FluxModelSpecification, "load_latent_models", port_latent)
    jax_runner.Inference(jax_runner.parse_args(argv + ["--output_dir", str(tmp_path / "jax")])).run()
    paths = inference.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"],
                           transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
    np.testing.assert_allclose(record_latents["port"], record_latents["jax"], atol=LATENT_ATOL, rtol=0)
    _assert_images_agree(images["jax"], images["port"])
    assert [pathlib.Path(p).name for p in paths] == ["output-0-0000-0.png"]
    written = cv2.cvtColor(cv2.imread(paths[0]), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(written, images["port"])
    manifest = json.loads(next((tmp_path / "port").glob("manifest-*.json")).read_text())
    assert manifest == [{"type": "image", "path": paths[0], "caption": REQUEST["prompt"]}]
    assert [p.name for p in (tmp_path / "jax").glob("*.png")] == ["output-0-0000-0.png"]


class _RecordingEncoder(HashEncoder):
    """A HashEncoder that records which of its encodes ran."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []

    def encode(self, captions, max_sequence_length=None):
        self.calls.append("encode")
        return super().encode(captions, max_sequence_length)

    def encode_pooled(self, captions):
        self.calls.append("encode_pooled")
        return super().encode_pooled(captions)


def test_t5_slot_takes_the_clip_encoder_as_in_jax():
    """A JAX quirk the port reproduces (ROADMAP.md section 3): `prepare_conditions`
    encodes the T5 slot with `text_encoder` when `text_encoder_2` is None, and
    `FluxPipeline` passes only `text_encoder`, so serving encodes both slots
    with one encoder (with real towers, T5 states of CLIP's width). Given a
    second encoder, the T5 slot takes it."""
    spec = _port_spec()
    clip, t5 = _RecordingEncoder(hidden_size=32, pooled_dim=24), _RecordingEncoder(hidden_size=40, pooled_dim=8)
    pipe = FluxPipeline(spec=spec, transformer=None, vae=None, text_encoder=clip, scheduler=FlowMatchEulerScheduler())
    ehs, pooled = pipe.encode_prompt("a fox")
    assert clip.calls == ["encode_pooled", "encode"] and ehs.shape == (1, 512, 32) and pooled.shape == (1, 24)
    jax_spec = JaxSpec(transformer_config=TINY)
    caption = "a trtcrd of a lighthouse"
    for slot_2 in (None, t5):
        jax_slot_2 = None if slot_2 is None else JaxHashEncoder(hidden_size=40, pooled_dim=8)
        got = spec.prepare_conditions(caption=caption, text_encoder=clip, text_encoder_2=slot_2)
        ref = jax_spec.prepare_conditions(caption=caption, text_encoder=JaxHashEncoder(hidden_size=32, pooled_dim=24),
                                          text_encoder_2=jax_slot_2)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert np.asarray(got[key]).tobytes() == np.asarray(ref[key]).tobytes(), key
        assert got["encoder_hidden_states"].shape == (1, 512, 32 if slot_2 is None else 40)
    assert t5.calls == ["encode"]


def test_registry_resolves_flux_and_spec_is_offline(tmp_path):
    """`flux` resolves for lora and full-finetune; the spec's offline components
    are JAX's fallbacks; a local tower directory that does not load falls back
    to the hash encoder in its slot, a VAE directory with a config but no
    weights gives a random 2D AutoencoderKL with Flux's statistics, a
    transformer directory without shards raises FileNotFoundError, all as in
    JAX (the directories that load: test_torch_family_checkpoints.py); an image
    VAE the port does not have raises naming its ROADMAP.md item."""
    for training_type in ("lora", "full-finetune"):
        assert get_model_specification_cls("flux", training_type) is FluxModelSpecification
    spec = FluxModelSpecification(device="cpu")
    models = spec.load_condition_models()
    for slot in ("text_encoder", "text_encoder_2"):
        encoder = models[slot]
        assert (encoder.hidden_size, encoder.max_length, encoder.pooled_dim) == (4096, 512, 768)
    assert spec.vae_autoencoder_config == autoencoders.SD_VAE_CONFIG
    assert autoencoders.SD_VAE_CONFIG == autoencoders.AutoencoderConfig(**vars(jax_ae.SD_VAE_CONFIG))
    assert isinstance(_port_spec().load_diffusion_models()["scheduler"], FlowMatchEulerScheduler)
    assert _port_spec().load_diffusion_models()["scheduler"].use_dynamic_shifting
    vae = _port_spec().load_latent_models()["vae"]
    assert (vae.config["scaling_factor"], vae.config["shift_factor"]) == (0.3611, 0.1159)
    tiny_vae = dict(latent_channels=4, block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4)
    for sub in ("text_encoder", "text_encoder_2", "vae", "transformer"):
        root = tmp_path / sub
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(tiny_vae if sub == "vae" else {}))
        local = FluxModelSpecification(pretrained_model_name_or_path=str(root), device="cpu",
                                       transformer_config=TINY)
        if sub.startswith("text_encoder"):
            assert isinstance(local.load_condition_models()[sub], HashEncoder)
        elif sub == "vae":
            vae = local.load_latent_models()["vae"]
            assert type(vae.module).__name__ == "AutoencoderKL"
            assert (vae.config["scaling_factor"], vae.config["shift_factor"]) == (0.3611, 0.1159)
        else:
            with pytest.raises(FileNotFoundError):
                local.load_diffusion_models()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 5"):
        autoencoders.encode_image_vae(autoencoders.ModelHandle(torch.nn.Linear(1, 1)), torch.zeros(1, 3, 8, 8))
