"""The HunyuanVideo serving slice as a whole: JAX `HunyuanVideoPipeline` and the
JAX runner (`examples/inference/inference.py --model_name hunyuan_video
--inference_type text_to_video`) against the port's.

Both packages build the tiny HunyuanVideo spec in fp32 (2 dual, 2 single and
2 refiner blocks, 2 heads of 64, a VAE of 8-16 channels with one 2x spatial
and one 2x temporal stage) with the offline `HashEncoder` in both text slots
(256 text tokens, no template crop, 71 valid: the template alone is 58
words), the guidance embedded and 2 flow-match Euler steps with shift 7.
The port gets JAX's transformer and VAE weights through the bridge and JAX's
initial draw `jax.random.normal(PRNGKey(seed), shape)` as `latents=`. The
final latents before the VAE agree at atol 1e-3 and the uint8 frames within
1 level (fp32 sums in another order can move a value across a rounding
boundary of the final `* 255` cast). `LlamaProcessor`'s embeds and mask are
byte-equal to JAX's, with and without the template crop. The runner writes
one .mp4, as JAX's does, and passes its default `--guidance_scale` 5.0 on;
the pipeline's own default is 6.0, as JAX's. The pooled slot's quirk (both
slots encoded by the pipeline's one encoder) is pinned on both sides.
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
from finetrainers_tpu.models.hunyuan_video import HunyuanVideoModelSpecification as JaxSpec
from finetrainers_tpu.models.hunyuan_video import HunyuanVideoTransformer3DModel as JaxHunyuan
from finetrainers_tpu.models.hunyuan_video.pipeline import HunyuanVideoPipeline as JaxHunyuanPipeline
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu.processors import LlamaProcessor as JaxLlamaProcessor
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import get_model_specification_cls, inference
from finetrainers_tpu_torch.data.utils import load_video
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.hunyuan_video import (HunyuanVideoModelSpecification, HunyuanVideoPipeline,
                                                         load_flax_params)
from finetrainers_tpu_torch.processors import HashEncoder, LlamaProcessor
from finetrainers_tpu_torch.schedulers import FlowMatchEulerScheduler
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
_runner_spec = importlib.util.spec_from_file_location("jax_inference_runner_hunyuan",
                                                      REPO_ROOT / "examples/inference/inference.py")
jax_runner = importlib.util.module_from_spec(_runner_spec)
_runner_spec.loader.exec_module(jax_runner)

TINY = dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=64, num_layers=2,
            num_single_layers=2, num_refiner_layers=2, text_embed_dim=32, pooled_projection_dim=24,
            guidance_embeds=True, rope_axes_dim=(16, 24, 24))
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, spatial_downsample=(True,),
              temporal_downsample=(True,))
PROMPT = "DISSOLVE A fox figurine dissolves into a cloud of red particles that drift away."
REQUEST = dict(prompt=PROMPT, height=16, width=24, num_frames=5, num_inference_steps=2, guidance_scale=6.0, seed=0)
LATENT_SHAPE = (1, 4, 3, 8, 12)
LATENT_ATOL = 1e-3


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


@functools.lru_cache(maxsize=None)
def jax_weights():
    """The tiny transformer's and VAE's JAX inits (`drawn_params`: eager flax init costs tens of seconds), with
    every bias and norm scale moved off its init."""
    module = JaxHunyuan(**TINY, dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 4, 1, 4, 4)), jnp.zeros((1, 8, 32)),
                          jnp.zeros((1,)), jnp.zeros((1, 24)))
    flat = _flat(params)
    rng = np.random.RandomState(7)
    for key in flat:
        if key.endswith(("bias", "scale")):
            flat[key] = flat[key] + 0.1 * rng.randn(*flat[key].shape).astype(np.float32)
    vae_module = jax_ae.AutoencoderKL3D(jax_ae.AutoencoderConfig(**VAE_KW), dtype=jnp.float32)
    vae_params = drawn_params(vae_module, jnp.zeros((1, 3, 1, 2, 2)))
    return module, flat, vae_module, vae_params


def jax_handles():
    """JAX's offline `load_diffusion_models` / `load_latent_models` (:93-134) with the inits above."""
    module, flat, vae_module, vae_params = jax_weights()
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    transformer = JaxHandle(module, tree, dict(TINY))
    vae = JaxHandle(vae_module, vae_params, {"latent_channels": 4, "spatial_compression_ratio": 2,
                                             "temporal_compression_ratio": 2, "scaling_factor": 0.476986})
    return transformer, vae


def port_spec(**kwargs):
    return HunyuanVideoModelSpecification(transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW),
                                          device="cpu", transformer_dtype=torch.float32, vae_dtype=torch.float32,
                                          **kwargs)


def bridge_transformer(module):
    load_flax_params(module, jax_weights()[1])


def bridge_vae(module):
    autoencoders.load_flax_vae_params(module, _flat(jax_weights()[3]))


def jax_draw(seed, shape=LATENT_SHAPE):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _offline_encoder(cls, hidden_size=32, pooled_dim=24):
    encoder = cls(hidden_size=hidden_size, max_length=256, pooled_dim=pooled_dim)
    encoder.supports_template_crop = False
    return encoder


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


@pytest.mark.parametrize("crop", [False, True], ids=["offline_no_crop", "template_crop"])
def test_llama_processor_matches_jax_exactly(crop):
    """The templated caption's embeds and mask byte-equal to JAX's, with the
    offline encoder's crop of 0 (the template alone fills 58 of the 256
    slots) and with the crop of 95 a real Llama tower takes."""
    captions = [PROMPT, ""]
    encoders = []
    for cls in (JaxHashEncoder, HashEncoder):
        encoder = cls(hidden_size=32, max_length=256)
        if not crop:
            encoder.supports_template_crop = False
        encoders.append(encoder)
    names = ["encoder_hidden_states", "encoder_attention_mask"]
    ref = JaxLlamaProcessor(names)(text_encoder=encoders[0], caption=captions, max_sequence_length=256)
    got = LlamaProcessor(names)(text_encoder=encoders[1], caption=captions, max_sequence_length=256)
    assert got[names[0]].shape == (2, 256, 32) and got[names[1]].shape == (2, 256)
    for key in names:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        assert got[key].tobytes() == ref[key].tobytes(), key
    if not crop:  # the template alone is 58 words
        valid = got["encoder_attention_mask"].sum(axis=1)
        assert valid[1] == 58 and valid[0] == 57 + len(PROMPT.split())  # the last word takes "<|eot_id|>"


def test_text_to_video_matches_jax(record_latents):
    transformer, vae = jax_handles()
    spec = JaxSpec(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW))
    spec.transformer_dtype = spec.vae_dtype = jnp.float32
    jax_pipe = spec.load_pipeline(transformer=transformer, vae=vae, text_encoder=_offline_encoder(JaxHashEncoder))
    ref = jax_pipe(**REQUEST)
    pspec = port_spec()
    port_transformer = pspec.load_diffusion_models()["transformer"]
    port_vae = pspec.load_latent_models()["vae"]
    bridge_transformer(port_transformer.module)
    bridge_vae(port_vae.module)
    pipe = pspec.load_pipeline(transformer=port_transformer, vae=port_vae, text_encoder=_offline_encoder(HashEncoder))
    assert isinstance(pipe, HunyuanVideoPipeline) and pipe.latent_shape(5, 16, 24) == LATENT_SHAPE
    assert pipe.scheduler.shift == 7.0
    video = pipe(**REQUEST, latents=torch.from_numpy(jax_draw(REQUEST["seed"])))
    np.testing.assert_allclose(record_latents["port"], record_latents["jax"], atol=LATENT_ATOL, rtol=0)
    assert_videos_agree(ref, video)
    # Without an explicit draw the seeded generator's, reproducibly.
    request = {**REQUEST, "num_inference_steps": 1}
    np.testing.assert_array_equal(pipe(**request), pipe(**request))


def test_guidance_defaults_are_jax_s():
    """The pipeline's `guidance_scale` defaults to 6.0 and the runner's to 5.0, as in JAX."""
    for fn in (HunyuanVideoPipeline.__call__, JaxHunyuanPipeline.__call__):
        assert inspect.signature(fn).parameters["guidance_scale"].default == 6.0
    argv = ["--model_name", "hunyuan_video", "--pretrained_model_name_or_path", "ckpt"]
    assert inference.parse_args(argv).guidance_scale == jax_runner.parse_args(argv).guidance_scale == 5.0


class _TinyJaxHunyuan(JaxSpec):
    """JAX's HunyuanVideo spec at the tiny config, in fp32, with the inits above (the runner passes no config)."""

    def __init__(self, **kwargs):
        kwargs.pop("transformer_dtype", None), kwargs.pop("vae_dtype", None)
        super().__init__(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW), **kwargs)
        self.transformer_dtype = self.vae_dtype = jnp.float32

    def load_diffusion_models(self):
        return {"transformer": jax_handles()[0], "scheduler": JaxScheduler(shift=7.0)}

    def load_latent_models(self):
        return {"vae": jax_handles()[1]}


def test_text_to_video_through_main_matches_jax_runner(tmp_path, monkeypatch, record_latents):
    """`inference.main --model_name hunyuan_video --inference_type
    text_to_video --device cpu` against the JAX runner, with `--attn_provider
    flash` as the example passes it and a scheduler config written as the
    public checkpoint names it (flow-match Euler, shift 7): the same video,
    the runner's default guidance 5.0, one .mp4 each and a manifest."""
    ckpt = tmp_path / "ckpt"
    (ckpt / "scheduler").mkdir(parents=True)
    (ckpt / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", "num_train_timesteps": 1000, "shift": 7.0}))
    argv = ["--model_name", "hunyuan_video", "--pretrained_model_name_or_path", str(ckpt), "--inference_type",
            "text_to_video", "--prompt", PROMPT, "--height", "16", "--width", "24", "--num_frames", "5",
            "--num_inference_steps", "2", "--seed", "4", "--attn_provider", "flash", "--transformer_dtype", "fp32",
            "--vae_dtype", "fp32"]
    videos = {}
    jax_call, port_call = JaxHunyuanPipeline.__call__, HunyuanVideoPipeline.__call__
    port_load_diffusion = HunyuanVideoModelSpecification.load_diffusion_models
    port_load_latent = HunyuanVideoModelSpecification.load_latent_models

    def jax_pipeline_call(self, **kwargs):
        videos["jax"] = jax_call(self, **kwargs)
        return videos["jax"]

    def port_pipeline_call(self, **kwargs):
        assert isinstance(self.scheduler, FlowMatchEulerScheduler) and self.scheduler.shift == 7.0
        assert kwargs["guidance_scale"] == 5.0 and kwargs["num_frames"] == 5
        videos["port"] = port_call(self, **kwargs, latents=torch.from_numpy(jax_draw(kwargs["seed"])))
        return videos["port"]

    def port_diffusion(self):
        out = port_load_diffusion(self)
        bridge_transformer(out["transformer"].module)
        return out

    def port_latent(self):
        out = port_load_latent(self)
        bridge_vae(out["vae"].module)
        return out

    monkeypatch.setattr(jax_config, "_get_model_specifiction_cls", lambda name, training_type: _TinyJaxHunyuan)
    monkeypatch.setattr(JaxHunyuanPipeline, "__call__", jax_pipeline_call)
    monkeypatch.setattr(HunyuanVideoPipeline, "__call__", port_pipeline_call)
    monkeypatch.setattr(HunyuanVideoModelSpecification, "load_diffusion_models", port_diffusion)
    monkeypatch.setattr(HunyuanVideoModelSpecification, "load_latent_models", port_latent)
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


class _RecordingEncoder(HashEncoder):
    """A HashEncoder that records which of its encodes ran."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []
        self.supports_template_crop = False

    def encode(self, captions, max_sequence_length=None):
        self.calls.append("encode")
        return super().encode(captions, max_sequence_length)

    def encode_pooled(self, captions):
        self.calls.append("encode_pooled")
        return super().encode_pooled(captions)


def test_pooled_slot_takes_the_llama_encoder_as_in_jax():
    """A JAX quirk the port reproduces (ROADMAP.md section 3, finding 14):
    `prepare_conditions` encodes the pooled CLIP slot with `text_encoder` when
    `text_encoder_2` is None, and `HunyuanVideoPipeline` passes only
    `text_encoder`, so serving encodes both slots with the one Llama-slot
    encoder. Given a second encoder, the pooled slot takes it."""
    spec = port_spec()
    llama, clip = _RecordingEncoder(hidden_size=32, pooled_dim=24), _RecordingEncoder(hidden_size=40, pooled_dim=8)
    pipe = HunyuanVideoPipeline(spec=spec, transformer=None, vae=None, text_encoder=llama,
                                scheduler=FlowMatchEulerScheduler(shift=7.0))
    ehs, mask, pooled = pipe.encode_prompt("a fox")
    assert llama.calls == ["encode", "encode_pooled"]
    assert ehs.shape == (1, 256, 32) and mask.shape == (1, 256) and pooled.shape == (1, 24)
    jax_spec = JaxSpec(transformer_config=TINY)
    for slot_2 in (None, clip):
        jax_slot_2 = None if slot_2 is None else _offline_encoder(JaxHashEncoder, 40, 8)
        got = spec.prepare_conditions(caption=PROMPT, text_encoder=llama, text_encoder_2=slot_2)
        ref = jax_spec.prepare_conditions(caption=PROMPT, text_encoder=_offline_encoder(JaxHashEncoder),
                                          text_encoder_2=jax_slot_2)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert np.asarray(got[key]).tobytes() == np.asarray(ref[key]).tobytes(), key
        assert got["pooled_projections"].shape == (1, 24 if slot_2 is None else 8)
    assert clip.calls == ["encode_pooled"]


def test_registry_resolves_hunyuan_and_spec_is_offline(tmp_path):
    """`hunyuan_video` resolves for lora and full-finetune; the spec's offline
    components are JAX's fallbacks (the hash encoder of width 4096, 256 slots,
    pooled 768, no template crop, in both slots; `HUNYUAN_VAE_CONFIG` with
    scaling 0.476986; Euler with shift 7); a local tower directory loads
    (tests/test_torch_text_towers.py), or where it does not load falls back to
    the hash encoder in its slot, a VAE directory with a config but no weights
    gives the faithful VAE at random, a transformer directory without shards
    raises FileNotFoundError, all as in JAX (the directories that load:
    test_torch_family_checkpoints.py)."""
    for training_type in ("lora", "full-finetune"):
        assert get_model_specification_cls("hunyuan_video", training_type) is HunyuanVideoModelSpecification
    spec = HunyuanVideoModelSpecification(device="cpu")
    models = spec.load_condition_models()
    for slot in ("text_encoder", "text_encoder_2"):
        encoder = models[slot]
        assert (encoder.hidden_size, encoder.max_length, encoder.pooled_dim) == (4096, 256, 768)
        assert encoder.supports_template_crop is False
    assert spec.vae_autoencoder_config == autoencoders.HUNYUAN_VAE_CONFIG
    assert autoencoders.HUNYUAN_VAE_CONFIG == autoencoders.AutoencoderConfig(**vars(jax_ae.HUNYUAN_VAE_CONFIG))
    scheduler = port_spec().load_diffusion_models()["scheduler"]
    assert isinstance(scheduler, FlowMatchEulerScheduler) and scheduler.shift == 7.0
    assert port_spec().load_latent_models()["vae"].config["scaling_factor"] == 0.476986
    for sub in ("text_encoder", "text_encoder_2"):
        root = tmp_path / sub
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text("{}")
        local = HunyuanVideoModelSpecification(pretrained_model_name_or_path=str(root), device="cpu",
                                               transformer_config=TINY)
        fallback = local.load_condition_models()[sub]
        assert isinstance(fallback, HashEncoder) and fallback.supports_template_crop is False
    tiny_vae = dict(latent_channels=4, block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4)
    for sub in ("vae", "transformer"):
        root = tmp_path / sub
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(tiny_vae if sub == "vae" else {}))
        local = HunyuanVideoModelSpecification(pretrained_model_name_or_path=str(root), device="cpu",
                                               transformer_config=TINY)
        if sub == "vae":
            vae = local.load_latent_models()["vae"]
            assert type(vae.module).__name__ == "AutoencoderKLHunyuanVideo" and vae.config["scaling_factor"] == 0.476986
        else:
            with pytest.raises(FileNotFoundError):
                local.load_diffusion_models()
