"""The CogView4 serving slice as a whole: JAX `CogView4Pipeline` and the JAX
runner (`examples/inference/inference.py --model_name cogview4
--inference_type text_to_image`, with and without `--training_type
control-lora`) against the port's.

Both packages build the tiny CogView4 spec in fp32 (2 blocks, 2 heads of 64,
a VAE of 8-16 channels with one 2x spatial stage and no temporal one) with
`HashEncoder(32, max_length=16)`, whose states `prepare_conditions` pads to
1024 slots, CFG as a batch of 2 with the empty negative prompt, sizes and
crops doubled, 2 flow-match Euler steps. The control model takes 8 input
channels (2x the 4 latent channels) and a uint8 control image, encoded as
one frame; its posterior mean joins the latents each step. The port gets
JAX's transformer and VAE weights through the bridge and JAX's initial draw
`jax.random.normal(PRNGKey(seed), shape)` as `latents=`. The final latents
before the VAE agree at atol 1e-3 and the uint8 images within 1 level. The
runners load an adapter and `control_aux_weights.safetensors` that the JAX
package wrote (JAX's flat flax names, (in, out) kernels).
"""

import functools
import importlib.util
import json
import pathlib
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import finetrainers_tpu.config as jax_config
from finetrainers_tpu.lora import save_lora_weights as jax_save_lora_weights
from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.cogview4 import CogView4ControlModelSpecification as JaxControlSpec
from finetrainers_tpu.models.cogview4 import CogView4ModelSpecification as JaxSpec
from finetrainers_tpu.models.cogview4 import CogView4Transformer2DModel as JaxCogView4
from finetrainers_tpu.models.cogview4.pipeline import CogView4Pipeline as JaxPipeline
from finetrainers_tpu.models.cogview4.weights import cogview4_key_map as jax_key_map
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu.trainer.control_trainer import ControlTrainer as JaxControlTrainer
from finetrainers_tpu_torch import get_model_specification_cls, inference
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.cogview4 import (
    CogView4ControlModelSpecification,
    CogView4ModelSpecification,
    CogView4Pipeline,
    load_flax_params,
)
from finetrainers_tpu_torch.models.autoencoder_kl import AutoencoderKL
from finetrainers_tpu_torch.models.cogview4 import pipeline as cogview4_pipeline
from finetrainers_tpu_torch.processors import HashEncoder
from finetrainers_tpu_torch.schedulers import FlowMatchEulerScheduler
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
_runner_spec = importlib.util.spec_from_file_location("jax_inference_runner_cogview4",
                                                      REPO_ROOT / "examples/inference/inference.py")
jax_runner = importlib.util.module_from_spec(_runner_spec)
_runner_spec.loader.exec_module(jax_runner)

TINY = dict(in_channels=4, out_channels=4, patch_size=2, num_attention_heads=2, attention_head_dim=64,
            num_layers=2, text_embed_dim=32, time_embed_dim=32, condition_dim=16)
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, spatial_downsample=(True,),
              temporal_downsample=(False,))
REQUEST = dict(prompt="a photo of a mountain lake at dawn", height=16, width=24, num_inference_steps=2,
               guidance_scale=3.5, seed=0)
LATENT_ATOL = 1e-3
RANK = 4


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


@functools.lru_cache(maxsize=None)
def jax_transformer(in_channels=4, lora_rank=0):
    """JAX's init of the tiny transformer (`drawn_params`), with every LoRA B factor nonzero."""
    cfg = dict(TINY, in_channels=in_channels)
    module = JaxCogView4(**cfg, lora_rank=lora_rank, lora_alpha=float(max(lora_rank, 1)), dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, in_channels, 4, 4)),
                          jnp.zeros((1, 8, 32)), jnp.zeros((1,)))
    flat = _flat(params)
    rng = np.random.RandomState(5)
    flat = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32) if k.endswith("lora_b") else v for k, v in flat.items()}
    return module, flat, cfg


@functools.lru_cache(maxsize=None)
def jax_vae():
    module = jax_ae.AutoencoderKL3D(jax_ae.AutoencoderConfig(**VAE_KW), dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 3, 1, 2, 2)))
    return module, params


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def jax_handles(in_channels=4, lora_rank=0):
    module, flat, cfg = jax_transformer(in_channels, lora_rank)
    vae_module, vae_params = jax_vae()
    return (JaxHandle(module, unflatten(flat), cfg),
            JaxHandle(vae_module, vae_params, {"latent_channels": 4, "spatial_compression_ratio": 2}))


def port_spec(cls=CogView4ModelSpecification, **kwargs):
    return cls(transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW), device="cpu",
               transformer_dtype=torch.float32, vae_dtype=torch.float32, **kwargs)


def bridge(spec, handle, in_channels=4, lora_rank=0):
    load_flax_params(handle.module, jax_transformer(in_channels, lora_rank)[1])
    return handle


def bridge_vae(handle):
    autoencoders.load_flax_vae_params(handle.module, _flat(jax_vae()[1]))
    return handle


def draw(height, width, seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (1, 4, height // 2, width // 2), jnp.float32))


def control_image(seed=2):
    rng = np.random.RandomState(seed)
    return cv2.resize((rng.rand(4, 6, 3) * 255).astype(np.uint8), (24, 16), interpolation=cv2.INTER_LINEAR)


@pytest.fixture
def record_latents(monkeypatch):
    """The latents each package hands its VAE decode, by side."""
    seen = {}
    jax_decode, port_decode = jax_ae.decode_image_vae, cogview4_pipeline.decode_image_vae

    def jax_side(vae, z):
        seen["jax"] = np.asarray(z)
        return jax_decode(vae, z)

    def port_side(vae, z):
        seen["port"] = z.numpy().copy()
        return port_decode(vae, z)

    monkeypatch.setattr(jax_ae, "decode_image_vae", jax_side)
    monkeypatch.setattr(cogview4_pipeline, "decode_image_vae", port_side)
    return seen


def assert_images_agree(ref, image, shape=(16, 24, 3)):
    assert image.shape == ref.shape == shape and image.dtype == np.uint8
    assert np.abs(image.astype(np.int16) - ref.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("control", [False, True], ids=["text_to_image", "control_image"])
def test_pipeline_matches_jax(control, record_latents):
    in_channels = 8 if control else 4
    transformer, vae = jax_handles(in_channels)
    spec = (JaxControlSpec if control else JaxSpec)(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW))
    spec.transformer_dtype = spec.vae_dtype = jnp.float32
    jax_pipe = spec.load_pipeline(transformer=transformer, vae=vae,
                                  text_encoder=JaxHashEncoder(hidden_size=32, max_length=16))
    extra = {"control_image": control_image()} if control else {}
    ref = jax_pipe(**REQUEST, **extra)
    pspec = port_spec(CogView4ControlModelSpecification if control else CogView4ModelSpecification)
    handle = (pspec.load_diffusion_models(new_in_features=8) if control else pspec.load_diffusion_models())["transformer"]
    bridge(pspec, handle, in_channels)
    pipe = pspec.load_pipeline(transformer=handle, vae=bridge_vae(pspec.load_latent_models()["vae"]),
                               text_encoder=HashEncoder(hidden_size=32, max_length=16))
    assert isinstance(pipe, CogView4Pipeline) and pipe.latent_shape(16, 24) == (1, 4, 8, 12)
    image = pipe(**REQUEST, **extra, latents=torch.from_numpy(draw(16, 24, REQUEST["seed"])))
    np.testing.assert_allclose(record_latents["port"], record_latents["jax"], atol=LATENT_ATOL, rtol=0)
    assert_images_agree(ref, image)
    request = {**REQUEST, "num_inference_steps": 1, **extra}
    np.testing.assert_array_equal(pipe(**request), pipe(**request))


def test_control_latents_match_jax_posterior_mean():
    """The control image's channels: resized and cropped to the request, encoded
    as one frame, the posterior mean (JAX :45-55), from a float image too."""
    pspec = port_spec(CogView4ControlModelSpecification)
    pipe = CogView4Pipeline(spec=pspec, transformer=None, vae=bridge_vae(pspec.load_latent_models()["vae"]),
                            text_encoder=None, scheduler=FlowMatchEulerScheduler())
    image = cv2.resize(control_image(), (30, 20))  # resized to 16 x 24 and cropped
    got = pipe.control_latents(image, 16, 24)
    from finetrainers_tpu.functional.image import resize_crop_image

    img = resize_crop_image(np.moveaxis(image.astype(np.float32) / 127.5 - 1.0, -1, 0), (16, 24))
    vae_module, vae_params = jax_vae()
    moments = jax_ae.encode_media(JaxHandle(vae_module, vae_params, {}), jnp.asarray(img)[None, :, None])[:, :, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(moments)[:, :4], atol=1e-5, rtol=0)
    assert got.shape == (1, 4, 8, 12)
    as_float = pipe.control_latents(np.moveaxis(image.astype(np.float32) / 127.5 - 1.0, -1, 0), 16, 24)
    assert torch.equal(as_float, got)


def test_pipeline_refuses_a_control_image_the_model_cannot_take():
    pspec = port_spec()
    handle = pspec.load_diffusion_models()["transformer"]
    pipe = pspec.load_pipeline(transformer=handle, text_encoder=HashEncoder(hidden_size=32, max_length=16))
    with pytest.raises(ValueError, match="no control image"):
        pipe(**REQUEST, control_image=control_image())
    cspec = port_spec(CogView4ControlModelSpecification)
    pipe = cspec.load_pipeline(transformer=cspec.load_diffusion_models(new_in_features=8)["transformer"],
                               text_encoder=HashEncoder(hidden_size=32, max_length=16))
    with pytest.raises(ValueError, match="a control image"):
        pipe(**REQUEST)


class _TinyJax(JaxSpec):
    """JAX's CogView4 spec at the tiny config, in fp32, with the inits above."""

    def __init__(self, **kwargs):
        kwargs.pop("transformer_dtype", None), kwargs.pop("vae_dtype", None)
        super().__init__(transformer_config=TINY, vae_config=jax_ae.AutoencoderConfig(**VAE_KW), **kwargs)
        self.transformer_dtype = self.vae_dtype = jnp.float32

    def load_diffusion_models(self, new_in_features=None):
        return {"transformer": jax_handles(new_in_features or 4, self.lora_rank)[0], "scheduler": JaxScheduler()}

    def load_latent_models(self):
        return {"vae": jax_handles()[1]}

    def load_condition_models(self):
        return {"tokenizer": None, "text_encoder": JaxHashEncoder(hidden_size=32, max_length=16)}


class _TinyJaxControl(JaxControlSpec, _TinyJax):
    def __init__(self, **kwargs):
        _TinyJax.__init__(self, **kwargs)

    def load_diffusion_models(self, new_in_features=None):
        return _TinyJax.load_diffusion_models(self, new_in_features)


def write_jax_control_adapter(directory):
    """A control-lora export as the JAX trainer writes it: the adapter (peft
    names) and, beside it, `control_aux_weights.safetensors` with the
    injection layer under JAX's flat flax names (JAX trainer :120-135)."""
    _, flat, _ = jax_transformer(8, RANK)
    rng = np.random.RandomState(9)
    lora = {k: (rng.randn(*v.shape) * 0.2).astype(np.float32) for k, v in flat.items() if "lora_" in k}
    aux = {k: v + (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in flat.items()
           if k.startswith("patch_embed_proj.")}
    jax_save_lora_weights(str(directory), unflatten(lora), {"r": RANK, "lora_alpha": RANK,
                                                            "target_modules": "x"}, key_map=jax_key_map)
    JaxControlTrainer._save_auxiliary_weights(types.SimpleNamespace(model_specification=None), str(directory), {"trainable": unflatten({**lora, **aux})})
    return lora, aux


@pytest.mark.parametrize("control", [False, True], ids=["text_to_image", "control_lora"])
def test_runner_matches_jax_runner(control, tmp_path, monkeypatch, record_latents):
    """`inference.main --model_name cogview4 --inference_type text_to_image`
    against the JAX runner: plain, and as a control-lora checkpoint with the
    JAX-written adapter, aux file and `--control_image_path`. The same image,
    one .png each; the port's model carries the aux file's injection layer."""
    argv = ["--model_name", "cogview4", "--pretrained_model_name_or_path", str(tmp_path / "none"),
            "--inference_type", "text_to_image", "--prompt", REQUEST["prompt"], "--height", "16", "--width", "24",
            "--num_inference_steps", "2", "--guidance_scale", "3.5", "--seed", "4", "--transformer_dtype", "fp32",
            "--vae_dtype", "fp32"]
    aux = None
    if control:
        _, aux = write_jax_control_adapter(tmp_path / "adapter")
        cv2.imwrite(str(tmp_path / "edges.png"), cv2.cvtColor(control_image(), cv2.COLOR_RGB2BGR))
        argv += ["--training_type", "control-lora", "--lora_weights", str(tmp_path / "adapter"),
                 "--control_image_path", str(tmp_path / "edges.png")]
    images, served = {}, {}
    jax_call, port_call = JaxPipeline.__call__, CogView4Pipeline.__call__
    port_cls = CogView4ControlModelSpecification if control else CogView4ModelSpecification
    port_load, port_latent = port_cls.load_diffusion_models, port_cls.load_latent_models

    def jax_pipeline_call(self, **kwargs):
        images["jax"] = jax_call(self, **kwargs)
        return images["jax"]

    def port_pipeline_call(self, **kwargs):
        assert "num_frames" not in kwargs and kwargs["guidance_scale"] == 3.5
        assert ("control_image" in kwargs) == control
        served["module"] = self.transformer.module
        images["port"] = port_call(self, **kwargs, latents=torch.from_numpy(draw(16, 24, kwargs["seed"])))
        return images["port"]

    def port_diffusion(self, *args, **kwargs):
        out = port_load(self, *args, **kwargs)
        bridge(self, out["transformer"], out["transformer"].config["in_channels"], self.lora_rank)
        return out

    monkeypatch.setattr(jax_config, "_get_model_specifiction_cls",
                        lambda name, training_type: _TinyJaxControl if control else _TinyJax)
    monkeypatch.setattr(JaxPipeline, "__call__", jax_pipeline_call)
    monkeypatch.setattr(CogView4Pipeline, "__call__", port_pipeline_call)
    monkeypatch.setattr(port_cls, "load_diffusion_models", port_diffusion)
    monkeypatch.setattr(port_cls, "load_latent_models", lambda self: {"vae": bridge_vae(port_latent(self)["vae"])})
    jax_runner.Inference(jax_runner.parse_args(argv + ["--output_dir", str(tmp_path / "jax")])).run()
    paths = inference.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"],
                           transformer_config=TINY, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
    np.testing.assert_allclose(record_latents["port"], record_latents["jax"], atol=LATENT_ATOL, rtol=0)
    assert_images_agree(images["jax"], images["port"])
    assert [pathlib.Path(p).name for p in paths] == ["output-0-0000-0.png"]
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(paths[0]), cv2.COLOR_BGR2RGB), images["port"])
    if control:
        module = served["module"]
        np.testing.assert_array_equal(module.patch_embed.proj.weight.detach().numpy(), aux["patch_embed_proj.kernel"].T)
        np.testing.assert_array_equal(module.patch_embed.proj.bias.detach().numpy(), aux["patch_embed_proj.bias"])
        assert module.transformer_blocks[0].attn1.to_q.rank == RANK


def test_concatenate_mask_fails_in_jax_and_is_refused_by_the_port(tmp_path, monkeypatch):
    """ROADMAP.md section 3 finding 16: with `--frame_conditioning_concatenate_mask`
    the JAX runner widens the model to 3x the latent channels, but its pipeline
    joins no mask channel, so the request fails; the port raises before
    loading anything."""
    argv = ["--model_name", "cogview4", "--pretrained_model_name_or_path", str(tmp_path / "none"),
            "--inference_type", "text_to_image", "--prompt", "p", "--height", "16", "--width", "24",
            "--num_inference_steps", "1", "--training_type", "control-lora", "--frame_conditioning_concatenate_mask",
            "--control_image_path", str(tmp_path / "edges.png")]
    cv2.imwrite(str(tmp_path / "edges.png"), control_image())
    monkeypatch.setattr(jax_config, "_get_model_specifiction_cls", lambda name, training_type: _TinyJaxControl)
    runner = jax_runner.Inference(jax_runner.parse_args(argv + ["--output_dir", str(tmp_path / "jax")]))
    runner.prepare_models()
    assert runner.pipeline.transformer.config["in_channels"] == 12
    with pytest.raises(Exception):
        runner.run()
    monkeypatch.setattr(CogView4ControlModelSpecification, "load_diffusion_models",
                        lambda self, **kw: pytest.fail("a model was built before the flag was refused"))
    with pytest.raises(ValueError, match="finding 16"):
        inference.main(argv + ["--device", "cpu"])


def test_registry_resolves_cogview4_and_spec_is_offline(tmp_path):
    """`cogview4` resolves for the SFT and control training types; the
    spec's offline components are JAX's fallbacks (the hash encoder padded to
    1024 slots, `SD_VAE_CONFIG`, Euler). Local directories load (the
    checkpoint itself in tests/test_torch_cogview4_checkpoint.py): a tower
    directory that does not load falls back to the hash encoder, a VAE
    config without weights gives a random 2D AutoencoderKL, a transformer
    directory without shards raises FileNotFoundError, all three as in JAX;
    the control spec refuses a local transformer (ROADMAP.md section 3,
    finding 19)."""
    for training_type in ("lora", "full-finetune"):
        assert get_model_specification_cls("cogview4", training_type) is CogView4ModelSpecification
    for training_type in ("control-lora", "control-full-finetune"):
        assert get_model_specification_cls("cogview4", training_type) is CogView4ControlModelSpecification
    spec = CogView4ModelSpecification(device="cpu")
    encoder = spec.load_condition_models()["text_encoder"]
    assert (encoder.hidden_size, encoder.max_length) == (4096, 128)
    conds = spec.prepare_conditions(caption="a photo of a lake", text_encoder=HashEncoder(hidden_size=8))
    ref = JaxSpec().prepare_conditions(caption="a photo of a lake", text_encoder=JaxHashEncoder(hidden_size=8))
    assert conds["encoder_hidden_states"].shape == (1, 1024, 8)
    assert conds["encoder_hidden_states"].tobytes() == np.asarray(ref["encoder_hidden_states"]).tobytes()
    assert spec.vae_autoencoder_config == autoencoders.SD_VAE_CONFIG
    assert isinstance(port_spec().load_diffusion_models()["scheduler"], FlowMatchEulerScheduler)
    small_vae = {"block_out_channels": [8, 16], "latent_channels": 4, "norm_num_groups": 4, "layers_per_block": 1}
    for sub, config in (("text_encoder", {}), ("vae", small_vae), ("transformer", {})):
        root = tmp_path / sub
        (root / sub).mkdir(parents=True)
        (root / sub / "config.json").write_text(json.dumps(config))
        local = CogView4ModelSpecification(pretrained_model_name_or_path=str(root), device="cpu",
                                           transformer_config=TINY)
        if sub == "text_encoder":
            assert isinstance(local.load_condition_models()["text_encoder"], HashEncoder)
        elif sub == "vae":
            vae = local.load_latent_models()["vae"]
            assert isinstance(vae.module, AutoencoderKL) and vae.config["spatial_compression_ratio"] == 2
        else:
            with pytest.raises(FileNotFoundError):
                local.load_diffusion_models()
            control = CogView4ControlModelSpecification(pretrained_model_name_or_path=str(root), device="cpu",
                                                        transformer_config=TINY)
            with pytest.raises(NotImplementedError, match="finding 19"):
                control.load_diffusion_models(new_in_features=8)
