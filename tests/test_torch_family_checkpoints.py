"""CogVideoX, HunyuanVideo and FLUX.1 from a local diffusers directory, in both packages.

A tiny directory per family is written here with the JAX package's exporters:
`transformer/` (`export_*_transformer_state_dict` of a drawn JAX init, its
biases and norm scales moved off their init), `vae/` (the faithful
`AutoencoderKLCogVideoX` or `AutoencoderKLHunyuanVideo`, or Flux's 2D
`AutoencoderKL`, through their exporters, each config with its own latent
statistics) and the text towers in Hugging Face's names (T5, Llama and CLIP
text written from the port's towers, with Hugging Face's prefixes; the towers'
parity with JAX's handles is `test_torch_text_towers.py`'s and
`test_torch_t5_tower.py`'s). Both specs load the transformer and the VAE: the
port's base weights equal the files', its LoRA factors a fresh model's, JAX's
parameters the files' under its key map (so the port's module names are JAX's
exporter's); the transformer forward (JAX's sinusoidal embedding handed over,
as in the transformer tests) and the port's `prepare_latents` against JAX's
encode (jitted; CogVideoX's moments turned frames-first as its
`prepare_latents` turns them) agree within 1e-4 in fp32. Each slot holds its
tower, not the hash encoder. A missing or misshaped weight raises. The runner serves
CogVideoX from the directory with an adapter. Finding 14 (ROADMAP.md section
3): with a tower loaded in the first slot, JAX's Flux and HunyuanVideo
pipelines fail (CLIP-width states reach Flux's context embedder; JAX's Llama
handle has no pooled output), and the port's runner and its validating
trainer refuse before loading the transformer."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.autoencoder_kl import AutoencoderKL as JaxAE
from finetrainers_tpu.models.autoencoder_kl import AutoencoderKLConfig as JaxAEConfig
from finetrainers_tpu.models.autoencoder_kl import export_autoencoder_kl_state_dict
from finetrainers_tpu.models.cogvideox import CogVideoXModelSpecification as JaxCogSpec
from finetrainers_tpu.models.cogvideox import vae as jax_cog_vae
from finetrainers_tpu.models.cogvideox.transformer import CogVideoXTransformer3DModel as JaxCog
from finetrainers_tpu.models.cogvideox.weights import (cogvideox_key_map, export_cogvideox_transformer_state_dict,
                                                       load_cogvideox_transformer_params)
from finetrainers_tpu.models.flux import FluxModelSpecification as JaxFluxSpec
from finetrainers_tpu.models.flux.transformer import FluxTransformer2DModel as JaxFlux
from finetrainers_tpu.models.flux.weights import (export_flux_transformer_state_dict, flux_key_map,
                                                  load_flux_transformer_params)
from finetrainers_tpu.models.hunyuan_video import HunyuanVideoModelSpecification as JaxHySpec
from finetrainers_tpu.models.hunyuan_video import vae as jax_hy_vae
from finetrainers_tpu.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel as JaxHy
from finetrainers_tpu.models.hunyuan_video.weights import (export_hunyuan_transformer_state_dict, hunyuan_key_map,
                                                           load_hunyuan_transformer_params)
from finetrainers_tpu.models.layers import sinusoidal_timestep_embedding as jax_timestep_embedding
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.text_encoders import FlaxCLIPTextHandle, FlaxLlamaHandle
from finetrainers_tpu_torch import get_model_specification_cls, inference
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.models.autoencoder_kl import AutoencoderKL
from finetrainers_tpu_torch.models.cogvideox import transformer as cog_transformer
from finetrainers_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX
from finetrainers_tpu_torch.models.flux import transformer as flux_transformer
from finetrainers_tpu_torch.models.hunyuan_video import transformer as hy_transformer
from finetrainers_tpu_torch.models.hunyuan_video.vae import AutoencoderKLHunyuanVideo
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.text_encoders import (CLIPTextConfig, CLIPTextHandle, CLIPTextTower, DecoderConfig,
                                                         DecoderTextModel, LlamaHandle, T5Config, T5EncoderTower,
                                                         T5Handle)
from finetrainers_tpu_torch.models.weight_utils import load_diffusers_checkpoint_dir
from finetrainers_tpu_torch.trainer import SFTTrainer
from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict
from test_torch_cogvideox_vae import perturbed
from test_torch_video_checkpoint import T5_DIMS, StubTokenizer
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)
TOL = 1e-4
RANK = 4
VAE_3D = dict(latent_channels=4, block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4)
LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0)
CLIP = dict(vocab_size=99, hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=77, eos_token_id=98)
FAMILIES = {
    "cogvideox": dict(
        jax=(JaxCogSpec, JaxCog, load_cogvideox_transformer_params, export_cogvideox_transformer_state_dict,
             cogvideox_key_map),
        transformer=dict(in_channels=4, out_channels=4, patch_size=2, num_attention_heads=2, attention_head_dim=64,
                         num_layers=2, text_embed_dim=32, time_embed_dim=32, use_rotary_positional_embeddings=True,
                         use_learned_positional_embeddings=False),
        vae=dict(VAE_3D, scaling_factor=0.9, _class_name="AutoencoderKLCogVideoX"), vae_cls=AutoencoderKLCogVideoX,
        towers={"text_encoder": "t5"}, media=(5, 16, 16), moments=(1, 2, 8, 2, 2)),
    "hunyuan_video": dict(
        jax=(JaxHySpec, JaxHy, load_hunyuan_transformer_params, export_hunyuan_transformer_state_dict,
             hunyuan_key_map),
        transformer=dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=64, num_layers=2,
                         num_single_layers=2, num_refiner_layers=2, text_embed_dim=32, pooled_projection_dim=24,
                         guidance_embeds=True, rope_axes_dim=(16, 24, 24)),
        vae=dict(VAE_3D, scaling_factor=0.5, _class_name="AutoencoderKLHunyuanVideo"),
        vae_cls=AutoencoderKLHunyuanVideo, towers={"text_encoder": "llama", "text_encoder_2": "clip"},
        media=(5, 16, 16), moments=(1, 8, 2, 2, 2)),
    "flux": dict(
        jax=(JaxFluxSpec, JaxFlux, load_flux_transformer_params, export_flux_transformer_state_dict, flux_key_map),
        transformer=dict(in_channels=16, num_layers=2, num_single_layers=2, num_attention_heads=2,
                         attention_head_dim=64, pooled_projection_dim=24, joint_attention_dim=32,
                         guidance_embeds=True, axes_dims_rope=(16, 24, 24)),
        vae=dict(latent_channels=4, block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4,
                 scaling_factor=0.3, shift_factor=0.2, _class_name="AutoencoderKL"),
        vae_cls=AutoencoderKL, towers={"text_encoder": "clip", "text_encoder_2": "t5"}, media=(1, 16, 16),
        moments=(1, 8, 8, 8)),
}
PORT_TRANSFORMER_MODULES = {"cogvideox": cog_transformer, "hunyuan_video": hy_transformer, "flux": flux_transformer}


def _jax_example(family, cfg):
    """Example inputs for JAX's transformer init (only their shapes matter)."""
    if family == "cogvideox":
        return jnp.zeros((1, 1, 4, 4, 4)), jnp.zeros((1, 8, 32)), jnp.zeros((1,))
    if family == "hunyuan_video":
        return jnp.zeros((1, 4, 1, 4, 4)), jnp.zeros((1, 8, 32)), jnp.zeros((1,)), jnp.zeros((1, 24))
    return (jnp.zeros((1, 4, 16)), jnp.zeros((1, 8, 32)), jnp.zeros((1, 24)), jnp.zeros((1,)), jnp.zeros((4, 3)),
            jnp.zeros((8, 3)))


def _jax_vae(family):
    cfg = FAMILIES[family]["vae"]
    if family == "cogvideox":
        return jax_cog_vae.AutoencoderKLCogVideoX(jax_cog_vae.CogVideoXVAEConfig.from_hf(cfg), dtype=jnp.float32), \
            jax_cog_vae.export_cogvideox_vae_state_dict, jnp.zeros((1, 3, 1, 8, 8))
    if family == "hunyuan_video":
        return jax_hy_vae.AutoencoderKLHunyuanVideo(jax_hy_vae.HunyuanVAEConfig.from_hf(cfg), dtype=jnp.float32), \
            jax_hy_vae.export_hunyuan_vae_state_dict, jnp.zeros((1, 3, 1, 8, 8))
    return JaxAE(JaxAEConfig.from_hf(cfg), dtype=jnp.float32), export_autoencoder_kl_state_dict, jnp.zeros((1, 3, 2, 2))


def _tower_state(module, seed):
    """The port tower's random state, norm scales and biases drawn too."""
    init_parameters_(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
    return module.state_dict()


def _write(path, config, state, file):
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(config))
    safetensors_save_dict({k: torch.as_tensor(np.array(v)).contiguous() for k, v in state.items()}, str(path / file))


def _write_tower(kind, path):
    if kind == "t5":
        state = _tower_state(T5EncoderTower(T5Config.from_hf(T5_DIMS), torch.float32), 3)
        _write(path, T5_DIMS, state, "model.safetensors")
    elif kind == "llama":
        state = _tower_state(DecoderTextModel(DecoderConfig.llama(LLAMA), torch.float32), 0)
        _write(path, LLAMA, {f"model.{k}": v for k, v in state.items()}, "model.safetensors")
    else:
        state = _tower_state(CLIPTextTower(CLIPTextConfig.from_hf(CLIP), torch.float32), 6)
        _write(path, CLIP, {f"text_model.{k}": v for k, v in state.items()}, "model.safetensors")


def _write_checkpoint(family, root):
    """The family's tiny diffusers directory under `root` (see the module's docstring)."""
    fam = FAMILIES[family]
    _, jax_cls, _, export, _ = fam["jax"]
    module = jax_cls(**fam["transformer"], lora_rank=0, dtype=jnp.float32, use_scan=False)
    params = perturbed(drawn_params(module, *_jax_example(family, fam["transformer"]), seed=1), 1)
    _write(root / "transformer", dict(fam["transformer"], _class_name=jax_cls.__name__), export(params),
           "diffusion_pytorch_model.safetensors")
    vae_module, vae_export, example = _jax_vae(family)
    vae_params = perturbed(drawn_params(vae_module, example, seed=2), 2)
    _write(root / "vae", fam["vae"], vae_export(vae_params), "diffusion_pytorch_model.safetensors")
    for slot, kind in fam["towers"].items():
        _write_tower(kind, root / slot)
    (root / "model_index.json").write_text("{}")


@pytest.fixture(scope="module", params=list(FAMILIES))
def checkpoint(request, tmp_path_factory):
    """(family, root, the transformer's and the VAE's written states by name)."""
    family = request.param
    root = tmp_path_factory.mktemp(family)
    _write_checkpoint(family, root)
    return (family, root, load_diffusers_checkpoint_dir(str(root / "transformer")),
            load_diffusers_checkpoint_dir(str(root / "vae")))


def _port_spec(family, root, **kwargs):
    return get_model_specification_cls(family, "lora")(
        pretrained_model_name_or_path=str(root), transformer_config=FAMILIES[family]["transformer"], device="cpu",
        lora_rank=RANK, lora_alpha=RANK, transformer_dtype=torch.float32, vae_dtype=torch.float32,
        text_encoder_dtype=torch.float32, text_encoder_2_dtype=torch.float32, **kwargs)


def _jax_spec(family, root):
    """JAX's spec with its transformer init drawn (`drawn_params`); the checkpoint loads through its own path."""
    spec_cls, jax_cls, loader, _, _ = FAMILIES[family]["jax"]

    class Spec(spec_cls):
        def load_diffusion_models(self):
            module = jax_cls(**self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                             dtype=self.transformer_dtype, use_scan=False)
            params = drawn_params(module, *_jax_example(family, self.transformer_config), seed=5)
            params = self._maybe_load_pretrained_transformer(params, loader, module=module)
            return {"transformer": JaxHandle(module, params, dict(self.transformer_config))}

    return Spec(pretrained_model_name_or_path=str(root), transformer_config=FAMILIES[family]["transformer"],
                lora_rank=RANK, lora_alpha=RANK, transformer_dtype=jnp.float32, vae_dtype=jnp.float32)


@pytest.fixture(scope="module")
def loaded(checkpoint):
    """Both specs on the checkpoint and what each loads: {side: (spec, transformer, vae)}, and the port's
    condition models."""
    family, root = checkpoint[:2]
    out = {}
    for side, spec in (("port", _port_spec(family, root)), ("jax", _jax_spec(family, root))):
        out[side] = (spec, spec.load_diffusion_models()["transformer"], spec.load_latent_models()["vae"])
    out["conditions"] = out["port"][0].load_condition_models()
    return out


def test_checkpoint_loads_by_name_in_both_packages(checkpoint, loaded):
    family, root, transformer, vae = checkpoint
    fam = FAMILIES[family]
    spec, handle, ours_vae = loaded["port"]
    _, jax_handle, jax_vae = loaded["jax"]
    state = handle.module.state_dict()
    lora = {k: v for k, v in state.items() if ".lora_" in k}
    assert lora and state.keys() - lora.keys() == transformer.keys()
    assert all(torch.equal(state[k], v) for k, v in transformer.items())
    fresh = _port_spec(family, root / "absent").load_diffusion_models()["transformer"].module.state_dict()
    assert all(torch.equal(v, fresh[k]) for k, v in lora.items())
    key_map = fam["jax"][4]
    for key, value in flatten_params(jax_handle.params).items():
        if ".lora_" in key:
            continue
        value = np.asarray(value)
        want = transformer[key_map(key)].numpy()
        assert np.array_equal(value.T if key.endswith(".kernel") and value.ndim == 2 else value, want), key
    assert isinstance(ours_vae.module, fam["vae_cls"]) and type(jax_vae.module).__name__ == fam["vae"]["_class_name"]
    vae_state = ours_vae.module.state_dict()
    assert vae_state.keys() == vae.keys() and all(torch.equal(vae_state[k], v) for k, v in vae.items())
    for key in set(ours_vae.config) | set(jax_vae.config):
        np.testing.assert_array_equal(ours_vae.config[key], jax_vae.config[key], err_msg=key)
    assert ours_vae.config["scaling_factor"] == fam["vae"]["scaling_factor"]
    kinds = {"t5": T5Handle, "llama": LlamaHandle, "clip": CLIPTextHandle}
    for slot, kind in fam["towers"].items():
        assert isinstance(loaded["conditions"][slot], kinds[kind]), slot


def _forward_inputs(family):
    rng = np.random.RandomState(11)
    text = rng.randn(1, 8, 32).astype(np.float32)
    if family == "cogvideox":
        return rng.randn(1, 2, 4, 4, 4).astype(np.float32), text, np.asarray([3.0], np.float32)
    pooled = rng.randn(1, 24).astype(np.float32)
    if family == "hunyuan_video":
        return (rng.randn(1, 4, 2, 4, 4).astype(np.float32), text, np.asarray([500.0], np.float32), pooled,
                np.asarray([6000.0], np.float32))
    from finetrainers_tpu.models.flux.transformer import prepare_latent_image_ids

    return (rng.randn(1, 6, 16).astype(np.float32), text, pooled, np.asarray([500.0], np.float32),
            np.asarray(prepare_latent_image_ids(4, 6), np.float32), np.zeros((8, 3), np.float32),
            np.asarray([3500.0], np.float32))


def test_transformer_forward_and_vae_encode_match_jax(checkpoint, loaded, monkeypatch):
    family = checkpoint[0]
    fam = FAMILIES[family]
    port, transformer, vae = loaded["port"]
    _, jax_transformer, jax_vae = loaded["jax"]
    monkeypatch.setattr(PORT_TRANSFORMER_MODULES[family], "sinusoidal_timestep_embedding", lambda t, dim: (
        torch.from_numpy(np.array(jax_timestep_embedding(jnp.asarray(t.numpy()), dim)))))
    x = _forward_inputs(family)
    module, n = jax_transformer.module, {"cogvideox": 3, "hunyuan_video": 4, "flux": 6}[family]
    guidance = {} if family == "cogvideox" else {"guidance": x[n]}
    want = jax.jit(lambda p, *a, **kw: module.apply({"params": p}, *a, **kw))(jax_transformer.params, *x[:n],
                                                                               **guidance)
    with torch.no_grad():
        got = transformer.module(*map(torch.from_numpy, x[:n]), **{k: torch.from_numpy(v) for k, v in guidance.items()})
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    frames, h, w = fam["media"]
    media = np.random.RandomState(3).uniform(-1, 1, (frames, 3, h, w)).astype(np.float32)
    kwargs = dict(image=media[0]) if family == "flux" else dict(video=media)
    got = port.prepare_latents(vae, **kwargs)["latents"]
    x = media[:1] if family == "flux" else media[None].transpose(0, 2, 1, 3, 4)
    want = np.asarray(jax.jit(lambda p, v: jax_vae.module.apply({"params": p}, v, method=type(jax_vae.module).encode))(
        jax_vae.params, x))
    if family == "cogvideox":  # frames-first, as its prepare_latents turns them (JAX :147-156)
        want = want.transpose(0, 2, 1, 3, 4)
    assert tuple(got.shape) == want.shape == fam["moments"]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fault", ["missing", "misshaped"])
@pytest.mark.parametrize("component", ["transformer", "vae"])
def test_a_missing_or_misshaped_weight_raises(checkpoint, component, fault, tmp_path):
    family, root = checkpoint[:2]
    shutil.copytree(root / component, tmp_path / component)
    file = tmp_path / component / "diffusion_pytorch_model.safetensors"
    state = load_diffusers_checkpoint_dir(str(tmp_path / component))
    name = sorted(k for k in state if k.endswith(".weight"))[3]
    if fault == "missing":
        del state[name]
    else:
        state[name] = torch.cat([state[name], state[name][:1]])
    safetensors_save_dict(state, str(file))
    spec = _port_spec(family, tmp_path)
    load = spec.load_diffusion_models if component == "transformer" else spec.load_latent_models
    with pytest.raises(KeyError if fault == "missing" else ValueError, match="missing" if fault == "missing" else name):
        load()


def test_runner_serves_cogvideox_from_the_directory_with_an_adapter(tmp_path, monkeypatch):
    """`python -m finetrainers_tpu_torch.inference --model_name cogvideox` on
    the written directory with `--lora_weights` (nonzero B factors, rank 4):
    the served transformer holds the directory's base weights and the
    adapter's factors, T5 and the faithful VAE load, and a 5x16x16 video of 1
    DDIM step is written."""
    import cv2

    from finetrainers_tpu_torch.lora import extract_lora_state_dict, save_lora_weights
    from finetrainers_tpu_torch.models.cogvideox import CogVideoXPipeline

    root = tmp_path / "cogvideox"
    fam = FAMILIES["cogvideox"]
    base = _tower_state(cog_transformer.CogVideoXTransformer3DModel(**fam["transformer"], dtype=torch.float32), 7)
    _write(root / "transformer", fam["transformer"], base, "diffusion_pytorch_model.safetensors")
    vae = _tower_state(AutoencoderKLCogVideoX(jax_cog_vae.CogVideoXVAEConfig.from_hf(fam["vae"]), torch.float32), 8)
    _write(root / "vae", fam["vae"], vae, "diffusion_pytorch_model.safetensors")
    _write_tower("t5", root / "text_encoder")
    adapter = cog_transformer.CogVideoXTransformer3DModel(**fam["transformer"], lora_rank=RANK, lora_alpha=RANK,
                                                          dtype=torch.float32)
    init_parameters_(adapter, torch.Generator().manual_seed(9))
    with torch.no_grad():
        for name, p in adapter.named_parameters():
            if ".lora_B" in name:
                p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(10))
    lora = extract_lora_state_dict(adapter)
    save_lora_weights(str(tmp_path / "adapter"), lora, {"r": RANK, "lora_alpha": RANK})
    seen = []
    call = CogVideoXPipeline.__call__

    def recording(self, **kwargs):
        self.text_encoder.tokenizer = StubTokenizer()
        seen.append((dict(self.transformer.module.state_dict()), self.text_encoder, self.vae.module))
        return call(self, **kwargs)

    monkeypatch.setattr(CogVideoXPipeline, "__call__", recording)
    argv = ["--model_name", "cogvideox", "--pretrained_model_name_or_path", str(root), "--prompt", "a red fox",
            "--height", "16", "--width", "16", "--num_frames", "5", "--num_inference_steps", "1", "--lora_weights",
            str(tmp_path / "adapter"), "--transformer_dtype", "fp32", "--vae_dtype", "fp32", "--text_encoder_dtype",
            "fp32", "--device", "cpu", "--output_dir", str(tmp_path / "out")]
    paths = inference.main(argv, transformer_config=fam["transformer"])
    state, encoder, vae_module = seen[0]
    assert all(torch.equal(state[k], v) for k, v in base.items())
    assert all(torch.equal(state[k], v) for k, v in lora.items())
    assert isinstance(encoder, T5Handle) and isinstance(vae_module, AutoencoderKLCogVideoX)
    frames = cv2.VideoCapture(paths[0])
    ok, frame = frames.read()
    assert ok and frame.shape == (16, 16, 3)


class _Jitted:
    """A JAX tower module whose `apply` is jitted (eager flax costs seconds a call on the CPU)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply)


def test_a_tower_in_the_first_slot_fails_serving_in_jax_and_is_refused_by_the_port(checkpoint, loaded, tmp_path,
                                                                                   monkeypatch):
    """ROADMAP.md section 3 finding 14 with real towers: serving encodes the
    second slot with the first slot's encoder. For Flux and HunyuanVideo
    JAX's pipeline fails on the first request (Flux: CLIP's 24-wide states
    reach a context embedder that takes 32, as 768 reach 4096 at full width,
    and flax refuses the kernel's shape; HunyuanVideo: its Llama handle has no
    `encode_pooled`), and the port's runner and a trainer given
    `--validation_dataset_file` raise a ValueError naming the finding before
    the transformer loads; without validation the trainer goes on. CogVideoX
    has one tower, serves in both packages (the runner test above), and is not
    refused."""
    family, root = checkpoint[:2]
    spec_cls = get_model_specification_cls(family, "lora")
    monkeypatch.setattr(spec_cls, "load_diffusion_models", lambda self: pytest.fail("the transformer was loaded"))
    spec = _port_spec(family, root)
    trainer = SFTTrainer(BaseArgs(model_name=family), spec)
    with pytest.raises(pytest.fail.Exception, match="the transformer was loaded"):
        trainer.prepare()
    trainer = SFTTrainer(BaseArgs(model_name=family, validation_dataset_file=str(tmp_path / "validation.json")),
                         spec)
    if family == "cogvideox":
        with pytest.raises(pytest.fail.Exception, match="the transformer was loaded"):
            trainer.prepare()
        return
    with pytest.raises(ValueError, match="finding 14"):
        trainer.prepare()
    argv = ["--model_name", family, "--pretrained_model_name_or_path", str(root), "--prompt", "a red fox",
            "--height", "16", "--width", "16", "--num_inference_steps", "1", "--device", "cpu",
            "--output_dir", str(tmp_path / "out")]
    with pytest.raises(ValueError, match="finding 14"):
        inference.main(argv, transformer_config=FAMILIES[family]["transformer"])

    ref, jax_transformer, jax_vae = loaded["jax"]
    handle_cls = FlaxCLIPTextHandle if family == "flux" else FlaxLlamaHandle
    encoder = ref._load_text_tower(handle_cls, None, "text_encoder", lambda: pytest.fail("no tower loaded"))
    encoder.tokenizer, encoder.module = StubTokenizer(), _Jitted(encoder.module)
    pipe = ref.load_pipeline(transformer=jax_transformer, vae=jax_vae, text_encoder=encoder)
    request = dict(prompt="a red fox", height=16, width=16, num_inference_steps=1, seed=0)
    if family == "hunyuan_video":
        request["num_frames"] = 5
    with pytest.raises(Exception, match="encode_pooled" if family == "hunyuan_video" else "context_embedder"):
        pipe(**request)
