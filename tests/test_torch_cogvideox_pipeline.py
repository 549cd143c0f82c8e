"""The CogVideoX serving slice as a whole: JAX `CogVideoXPipeline` (DDIM) and
the JAX runner (`examples/inference/inference.py --model_name cogvideox
--inference_type text_to_video`) against the port's.

Both packages build the tiny CogVideoX spec in fp32 (2 blocks, 2 heads of 64,
the 5B's 3D RoPE, a VAE of 8-16 channels with one 2x spatial and one 2x
temporal stage) with the offline `HashEncoder` (226 slots) through
`T5Processor`, classifier-free guidance as one batch of 2 with the ""
negative prompt, and 3 DDIM steps over `linspace(999, 0, 3).round()`. The
port gets JAX's transformer and VAE weights through the bridge and JAX's
initial draw `jax.random.normal(PRNGKey(seed), shape)` as `latents=`. The
latents handed to the VAE decode agree at atol 1e-3 (the x0 estimate
multiplies the velocity by sqrt(1 - a), near 1 at t = 999) and the uint8
frames within 1 level. The runner writes one .mp4, as JAX's does, and passes
its default `--guidance_scale` 5.0 on; the pipeline's own default is 6.0, as
JAX's. `load_scheduler`'s DDIM branch against JAX's.
"""

import functools
import importlib.util
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import finetrainers_tpu.config as jax_config
from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.cogvideox import CogVideoXModelSpecification as JaxSpec
from finetrainers_tpu.models.cogvideox import CogVideoXTransformer3DModel as JaxCogVideoX
from finetrainers_tpu.models.cogvideox.pipeline import CogVideoXPipeline as JaxCogVideoXPipeline
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu.processors import T5Processor as JaxT5Processor
from finetrainers_tpu.schedulers import CogVideoXDDIMScheduler as JaxDDIM
from finetrainers_tpu.schedulers import load_scheduler as jax_load_scheduler
from finetrainers_tpu_torch import get_model_specification_cls, inference
from finetrainers_tpu_torch.data.utils import load_video
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.cogvideox import CogVideoXModelSpecification, CogVideoXPipeline, load_flax_params
from finetrainers_tpu_torch.processors import HashEncoder, T5Processor
from finetrainers_tpu_torch.schedulers import CogVideoXDDIMScheduler, FlowMatchEulerScheduler, load_scheduler
from test_torch_cogvideox_transformer import TINY, unflatten
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
_runner_spec = importlib.util.spec_from_file_location("jax_inference_runner_cogvideox",
                                                      REPO_ROOT / "examples/inference/inference.py")
jax_runner = importlib.util.module_from_spec(_runner_spec)
_runner_spec.loader.exec_module(jax_runner)

VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, spatial_downsample=(True,),
              temporal_downsample=(True,))
PROMPT = "PIKA_CRUSH A hydraulic press descends on a toy car, flattening it slowly."
REQUEST = dict(prompt=PROMPT, height=16, width=24, num_frames=5, num_inference_steps=3, guidance_scale=6.0, seed=0)
LATENT_SHAPE = (1, 3, 4, 8, 12)  # frames first
LATENT_ATOL = 1e-3


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


@functools.lru_cache(maxsize=None)
def jax_weights():
    """The tiny transformer's and VAE's JAX inits (`drawn_params`), with every bias and norm scale moved off
    its init."""
    module = JaxCogVideoX(**TINY, dtype=jnp.float32, use_scan=False)
    params = drawn_params(module, jnp.zeros((1, 1, 4, 4, 4)), jnp.zeros((1, 8, 32)),
                          jnp.zeros((1,)))
    flat = _flat(params)
    rng = np.random.RandomState(7)
    for key in flat:
        if key.endswith(("bias", "scale")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    vae_module = jax_ae.AutoencoderKL3D(jax_ae.AutoencoderConfig(**VAE_KW), dtype=jnp.float32)
    vae_params = drawn_params(vae_module, jnp.zeros((1, 3, 1, 2, 2)))
    return module, flat, vae_module, vae_params


def jax_handles():
    """JAX's offline `load_diffusion_models` / `load_latent_models` (:98-130) with the inits above."""
    module, flat, vae_module, vae_params = jax_weights()
    transformer = JaxHandle(module, unflatten(flat), dict(TINY))
    vae = JaxHandle(vae_module, vae_params, {"latent_channels": 4, "spatial_compression_ratio": 2,
                                             "temporal_compression_ratio": 2, "scaling_factor": 0.7})
    return transformer, vae


def port_spec(**kwargs):
    return CogVideoXModelSpecification(transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW),
                                       device="cpu", transformer_dtype=torch.float32, vae_dtype=torch.float32,
                                       **kwargs)


def bridged(spec):
    transformer = spec.load_diffusion_models()["transformer"]
    vae = spec.load_latent_models()["vae"]
    load_flax_params(transformer.module, jax_weights()[1])
    autoencoders.load_flax_vae_params(vae.module, _flat(jax_weights()[3]))
    return transformer, vae


def jax_draw(seed, shape=LATENT_SHAPE):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.fixture
def record_latents(monkeypatch):
    """The latents each package hands its VAE decode, by side."""
    seen = {}
    jax_apply, port_decode = JaxHandle.apply, autoencoders.AutoencoderKL3D.decode

    def jax_side(self, *args, **kwargs):
        if getattr(kwargs.get("method"), "__name__", None) == "decode":
            seen["jax"] = np.asarray(args[0])
        return jax_apply(self, *args, **kwargs)

    def port_side(self, z):
        seen["port"] = z.numpy().copy()
        return port_decode(self, z)

    monkeypatch.setattr(JaxHandle, "apply", jax_side)
    monkeypatch.setattr(autoencoders.AutoencoderKL3D, "decode", port_side)
    return seen


def assert_videos_agree(ref, video, shape=(5, 16, 24, 3)):
    assert video.shape == ref.shape == shape and video.dtype == np.uint8
    assert np.abs(video.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_t5_processor_matches_jax_exactly():
    """226-slot embeds (masked) and mask byte-equal to JAX's, the "" negative prompt's too."""
    names = ["encoder_hidden_states", "encoder_attention_mask"]
    captions = [PROMPT, ""]
    ref = JaxT5Processor(names)(text_encoder=JaxHashEncoder(32, 226), caption=captions, max_sequence_length=226)
    got = T5Processor(names)(text_encoder=HashEncoder(32, 226), caption=captions, max_sequence_length=226)
    assert got[names[0]].shape == (2, 226, 32)
    for key in names:
        assert got[key].dtype == ref[key].dtype and got[key].tobytes() == ref[key].tobytes(), key


@pytest.mark.parametrize("guidance_scale", [6.0, 1.0], ids=["cfg", "no_cfg"])
def test_text_to_video_matches_jax(record_latents, guidance_scale):
    transformer, vae = jax_handles()
    spec = JaxSpec(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW))
    spec.transformer_dtype = spec.vae_dtype = jnp.float32
    request = {**REQUEST, "guidance_scale": guidance_scale}
    ref = spec.load_pipeline(transformer=transformer, vae=vae, text_encoder=JaxHashEncoder(32, 226))(**request)
    pspec = port_spec()
    port_transformer, port_vae = bridged(pspec)
    pipe = pspec.load_pipeline(transformer=port_transformer, vae=port_vae, text_encoder=HashEncoder(32, 226))
    assert isinstance(pipe, CogVideoXPipeline) and isinstance(pipe.scheduler, CogVideoXDDIMScheduler)
    assert pipe.latent_shape(5, 16, 24) == LATENT_SHAPE
    video = pipe(**request, latents=torch.from_numpy(jax_draw(REQUEST["seed"])))
    assert record_latents["port"].shape == (1, 4, 3, 8, 12)  # channels first for the VAE
    np.testing.assert_allclose(record_latents["port"], record_latents["jax"], atol=LATENT_ATOL, rtol=0)
    assert_videos_agree(ref, video)
    if guidance_scale > 1.0:  # without an explicit draw the seeded generator's, reproducibly
        short = {**request, "num_inference_steps": 1}
        np.testing.assert_array_equal(pipe(**short), pipe(**short))


def test_guidance_defaults_are_jax_s():
    """The pipeline's `guidance_scale` defaults to 6.0 and the runner's to 5.0, as in JAX."""
    for fn in (CogVideoXPipeline.__call__, JaxCogVideoXPipeline.__call__):
        assert inspect.signature(fn).parameters["guidance_scale"].default == 6.0
    argv = ["--model_name", "cogvideox", "--pretrained_model_name_or_path", "ckpt"]
    assert inference.parse_args(argv).guidance_scale == jax_runner.parse_args(argv).guidance_scale == 5.0


class _TinyJaxCogVideoX(JaxSpec):
    """JAX's CogVideoX spec at the tiny config, in fp32, with the inits above and its offline text encoder."""

    def __init__(self, **kwargs):
        kwargs.pop("transformer_dtype", None), kwargs.pop("vae_dtype", None)
        super().__init__(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW), **kwargs)
        self.transformer_dtype = self.vae_dtype = jnp.float32

    def load_condition_models(self):
        return {"tokenizer": None, "text_encoder": JaxHashEncoder(hidden_size=32, max_length=226)}

    def load_diffusion_models(self):
        return {"transformer": jax_handles()[0], "scheduler": self._scheduler}

    def load_latent_models(self):
        return {"vae": jax_handles()[1]}


def test_text_to_video_through_main_matches_jax_runner(tmp_path, monkeypatch, record_latents):
    """`inference.main --model_name cogvideox --inference_type text_to_video
    --device cpu` with the flags cogvideox_text_to_video.sh passes
    (`--attn_provider flash`, slicing and tiling) against the JAX runner: the
    same video, DDIM, the runner's default guidance 5.0, one .mp4 each and a
    manifest."""
    argv = ["--model_name", "cogvideox", "--pretrained_model_name_or_path", str(tmp_path / "ckpt"),
            "--inference_type", "text_to_video", "--prompt", PROMPT, "--height", "16", "--width", "24",
            "--num_frames", "5", "--num_inference_steps", "2", "--seed", "4", "--attn_provider", "flash",
            "--enable_slicing", "--enable_tiling", "--transformer_dtype", "fp32", "--vae_dtype", "fp32"]
    videos = {}
    jax_call, port_call = JaxCogVideoXPipeline.__call__, CogVideoXPipeline.__call__

    def jax_pipeline_call(self, **kwargs):
        videos["jax"] = jax_call(self, **kwargs)
        return videos["jax"]

    def port_pipeline_call(self, **kwargs):
        assert isinstance(self.scheduler, CogVideoXDDIMScheduler) and self.vae.use_tiling and self.vae.use_slicing
        assert kwargs["guidance_scale"] == 5.0 and kwargs["num_frames"] == 5
        videos["port"] = port_call(self, **kwargs, latents=torch.from_numpy(jax_draw(kwargs["seed"])))
        return videos["port"]

    def port_diffusion(self):
        out = load_diffusion(self)
        load_flax_params(out["transformer"].module, jax_weights()[1])
        return out

    def port_latent(self):
        out = load_latent(self)
        autoencoders.load_flax_vae_params(out["vae"].module, _flat(jax_weights()[3]))
        return out

    load_diffusion = CogVideoXModelSpecification.load_diffusion_models
    load_latent = CogVideoXModelSpecification.load_latent_models
    monkeypatch.setattr(jax_config, "_get_model_specifiction_cls", lambda name, training_type: _TinyJaxCogVideoX)
    monkeypatch.setattr(JaxCogVideoXPipeline, "__call__", jax_pipeline_call)
    monkeypatch.setattr(CogVideoXPipeline, "__call__", port_pipeline_call)
    monkeypatch.setattr(CogVideoXModelSpecification, "load_diffusion_models", port_diffusion)
    monkeypatch.setattr(CogVideoXModelSpecification, "load_latent_models", port_latent)
    jax_runner.Inference(jax_runner.parse_args(argv + ["--output_dir", str(tmp_path / "jax")])).run()
    paths = inference.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"],
                           transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
    np.testing.assert_allclose(record_latents["port"], record_latents["jax"], atol=LATENT_ATOL, rtol=0)
    assert_videos_agree(videos["jax"], videos["port"])
    assert [pathlib.Path(p).name for p in paths] == ["output-0-0000-0.mp4"]
    assert load_video(paths[0]).shape[0] == 5
    manifest = json.loads(next((tmp_path / "port").glob("manifest-*.json")).read_text())
    assert manifest == [{"type": "video", "path": paths[0], "caption": PROMPT}]
    assert [p.name for p in (tmp_path / "jax").glob("*.mp4")] == ["output-0-0000-0.mp4"]


@pytest.mark.parametrize("name", ["CogVideoXDDIMScheduler", "DDIMScheduler"])
def test_load_scheduler_ddim_branch_matches_jax(tmp_path, name):
    """A DDIM scheduler config under a DDIM default gives the config's DDIM
    (its alpha-bar table equal to JAX's); under a flow-matching default the
    default stays, as in JAX (:456-468)."""
    cfg = {"_class_name": name, "num_train_timesteps": 1000, "beta_start": 0.001, "beta_end": 0.02,
           "snr_shift_scale": 2.0, "rescale_betas_zero_snr": False}
    (tmp_path / "scheduler").mkdir()
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(json.dumps(cfg))
    got = load_scheduler(str(tmp_path), default=CogVideoXDDIMScheduler())
    ref = jax_load_scheduler(str(tmp_path), default=JaxDDIM())
    assert isinstance(got, CogVideoXDDIMScheduler)
    assert (got.beta_start, got.beta_end, got.snr_shift_scale, got.rescale_betas_zero_snr) == (0.001, 0.02, 2.0, False)
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(), np.asarray(ref.alphas_cumprod))
    flow = FlowMatchEulerScheduler(shift=3.0)
    assert load_scheduler(str(tmp_path), default=flow) is flow


def test_registry_resolves_cogvideox_and_spec_is_offline(tmp_path):
    """`cogvideox` resolves for lora and full-finetune; the spec's offline
    components are JAX's fallbacks (the hash encoder of width 4096 with 226
    slots, `COGVIDEOX_VAE_CONFIG` with scaling 0.7, its own DDIM scheduler);
    a local T5 directory without weights falls back to the hash encoder, a
    VAE directory with a config but no weights gives the faithful VAE at
    random, a transformer directory without shards raises FileNotFoundError,
    all as in JAX (the directories that load: test_torch_family_checkpoints.py);
    the data keys are JAX's."""
    for training_type in ("lora", "full-finetune"):
        assert get_model_specification_cls("cogvideox", training_type) is CogVideoXModelSpecification
    spec = CogVideoXModelSpecification(device="cpu")
    encoder = spec.load_condition_models()["text_encoder"]
    assert (encoder.hidden_size, encoder.max_length) == (4096, 226)
    assert spec.vae_autoencoder_config == autoencoders.COGVIDEOX_VAE_CONFIG
    assert autoencoders.COGVIDEOX_VAE_CONFIG == autoencoders.AutoencoderConfig(**vars(jax_ae.COGVIDEOX_VAE_CONFIG))
    assert isinstance(port_spec().load_diffusion_models()["scheduler"], CogVideoXDDIMScheduler)
    assert port_spec().load_latent_models()["vae"].config["scaling_factor"] == 0.7 == JaxSpec().vae_scaling_factor
    assert spec.cp_plan() == JaxSpec().cp_plan() and spec._resolution_dim_keys == JaxSpec()._resolution_dim_keys
    tiny_vae = dict(latent_channels=4, block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4)
    for sub in ("text_encoder", "vae", "transformer"):
        root = tmp_path / sub
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(tiny_vae if sub == "vae" else {}))
        local = CogVideoXModelSpecification(pretrained_model_name_or_path=str(root), device="cpu",
                                            transformer_config=TINY)
        if sub == "text_encoder":  # T5 loads from a local directory; one without weights falls back, as in JAX
            assert isinstance(local.load_condition_models()["text_encoder"], HashEncoder)
        elif sub == "vae":
            vae = local.load_latent_models()["vae"]
            assert type(vae.module).__name__ == "AutoencoderKLCogVideoX" and vae.config["scaling_factor"] == 1.15258426
            assert local.vae_scaling_factor == 0.7 == JaxSpec().vae_scaling_factor
        else:
            with pytest.raises(FileNotFoundError):
                local.load_diffusion_models()


def test_prepare_latents_are_frames_first_moments_of_the_vae():
    """A video (T, C, H, W) in [-1, 1] -> the VAE's moments turned frames-first
    (1, F', 2C, H', W'), equal to JAX's `prepare_latents` on the same weights."""
    video = np.random.RandomState(5).uniform(-1, 1, (5, 3, 16, 24)).astype(np.float32)
    pspec = port_spec()
    _, port_vae = bridged(pspec)
    got = pspec.prepare_latents(vae=port_vae, video=video)["latents"]
    spec = JaxSpec(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW))
    ref = spec.prepare_latents(vae=jax_handles()[1], video=video)["latents"]
    assert tuple(got.shape) == ref.shape == (1, 3, 8, 8, 12)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
