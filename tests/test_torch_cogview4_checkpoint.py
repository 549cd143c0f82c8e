"""CogView4 from a local diffusers directory, in both packages: a tiny
checkpoint written here (`transformer/` with its config.json, `vae/` the 2D
AutoencoderKL at 8-16 channels with its scaling and shift, `text_encoder/` a
2-layer GLM with grouped kv heads and partial rotary) loads through both
specs. The base weights equal the file's, the LoRA factors are the fresh
init's, each handle is the tower's (not the hash encoder); `prepare_conditions`
through the loaded GLM (one stub tokenizer), the VAE's encode (through
`prepare_latents`) and decode, and a 2-step CFG request whose prompt the
loaded GLM encodes and whose latents the loaded VAE decodes agree within
1e-4 in fp32. JAX's spec is tiny and draws its transformer init in numpy (`drawn_params`:
an init compile costs seconds); its checkpoint loading is the package's own. Then the
control specs' transformers keep refusing a local directory (every other
family's components load: `test_torch_video_checkpoint.py`,
`test_torch_family_checkpoints.py`)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models import autoencoders as jax_ae
from finetrainers_tpu.models.autoencoder_kl import AutoencoderKL as JaxAutoencoderKL
from finetrainers_tpu.models.cogview4 import CogView4ModelSpecification as JaxSpec
from finetrainers_tpu.models.cogview4 import CogView4Transformer2DModel as JaxCogView4
from finetrainers_tpu.models.cogview4.weights import cogview4_key_map, load_cogview4_transformer_params
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.text_encoders import FlaxGlmHandle
from finetrainers_tpu_torch import get_model_specification_cls
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
from finetrainers_tpu_torch.models.cogview4 import CogView4ModelSpecification
from finetrainers_tpu_torch.models.cogview4 import pipeline as cogview4_pipeline
from finetrainers_tpu_torch.models.cogview4.transformer import CogView4Transformer2DModel
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.text_encoders import DecoderConfig, DecoderTextModel, GlmHandle
from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)
TOL = 1e-4
RANK = 4
TINY = dict(in_channels=4, out_channels=4, patch_size=2, num_attention_heads=2, attention_head_dim=64,
            num_layers=2, text_embed_dim=32, time_embed_dim=32, condition_dim=16)
VAE = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=[8, 16], layers_per_block=1,
           norm_num_groups=4, scaling_factor=0.5, shift_factor=0.125)
GLM = dict(vocab_size=128, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=8, partial_rotary_factor=0.5, attention_bias=True, pad_token_id=0)
REQUEST = dict(prompt="a photo of a mountain lake at dawn", height=16, width=24, num_inference_steps=2,
               guidance_scale=3.5, seed=0)


class StubTokenizer:
    """One id per word (3, 4, ...), padded with 0 to the longest caption."""

    pad_token_id = 0

    def __call__(self, texts, padding=None, max_length=None, truncation=None, return_tensors=None, **kw):
        width = max(len(t.split()) for t in texts) + 1
        ids = np.zeros((len(texts), width), np.int64)
        for i, t in enumerate(texts):
            ids[i, :len(t.split()) + 1] = (np.arange(len(t.split()) + 1) % 90) + 3
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def _perturbed(module, seed):
    """`module`'s random state with norm scales and biases drawn as well."""
    init_parameters_(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g) + (1.0 if name.endswith("norm.weight")
                                                                      or "norm1" in name or "norm2" in name
                                                                      or "layernorm" in name else 0.0))
    return {k: v.contiguous() for k, v in module.state_dict().items()}


def _write(path, config, state, file):
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(config))
    safetensors_save_dict(state, str(path / file))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("cogview4")
    transformer = _perturbed(CogView4Transformer2DModel(**TINY, dtype=torch.float32), 0)
    _write(root / "transformer", {"_class_name": "CogView4Transformer2DModel", **TINY}, transformer,
           "diffusion_pytorch_model.safetensors")
    vae = _perturbed(AutoencoderKL(AutoencoderKLConfig.from_hf(VAE), torch.float32), 2)
    _write(root / "vae", {"_class_name": "AutoencoderKL", **VAE}, vae, "diffusion_pytorch_model.safetensors")
    glm = _perturbed(DecoderTextModel(DecoderConfig.glm(GLM), torch.float32), 4)
    _write(root / "text_encoder", GLM, {f"model.{k}": v for k, v in glm.items()}, "model.safetensors")
    return root, transformer, vae


class _JaxSpec(JaxSpec):
    """JAX's spec with its transformer init drawn (`drawn_params`); the checkpoint loads through its own path."""

    def load_diffusion_models(self):
        module = JaxCogView4(**self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                             dtype=self.transformer_dtype)
        params = drawn_params(module, jnp.zeros((1, 4, 4, 4)), jnp.zeros((1, 8, 32)),
                              jnp.zeros((1,)))
        params = self._maybe_load_pretrained_transformer(params, load_cogview4_transformer_params, module=module)
        return {"transformer": JaxHandle(module, params, dict(self.transformer_config))}


@pytest.fixture(scope="module")
def loaded(checkpoint):
    """Both specs on the checkpoint and what each loads: {side: (spec, transformer, vae, condition models)}."""
    root = checkpoint[0]
    port = CogView4ModelSpecification(pretrained_model_name_or_path=str(root), transformer_config=TINY, device="cpu",
                                      lora_rank=RANK, lora_alpha=RANK, transformer_dtype=torch.float32,
                                      vae_dtype=torch.float32, text_encoder_dtype=torch.float32)
    ref = _JaxSpec(pretrained_model_name_or_path=str(root), transformer_config=TINY, lora_rank=RANK,
                   lora_alpha=RANK, transformer_dtype=jnp.float32, vae_dtype=jnp.float32)
    return {side: (spec, spec.load_diffusion_models()["transformer"], spec.load_latent_models()["vae"],
                   spec.load_condition_models()) for side, spec in (("port", port), ("jax", ref))}


def test_checkpoint_loads_as_written_in_both_packages(checkpoint, loaded):
    _, transformer, vae = checkpoint
    _, handle, ours_vae, ours_te = loaded["port"]
    _, jax_handle, jax_vae, jax_te = loaded["jax"]
    state = handle.module.state_dict()
    lora = {k: v for k, v in state.items() if ".lora_" in k}
    assert lora and all(torch.equal(state[k], v) for k, v in transformer.items())
    fresh = CogView4ModelSpecification(transformer_config=TINY, device="cpu", lora_rank=RANK, lora_alpha=RANK,
                                       transformer_dtype=torch.float32).load_diffusion_models()["transformer"]
    fresh_state = fresh.module.state_dict()
    assert all(torch.equal(v, fresh_state[k]) for k, v in lora.items())
    assert all(not v.any() for k, v in lora.items() if "lora_B" in k)
    jax_flat = {k: np.asarray(v) for k, v in flatten_params(jax_handle.params).items()}
    for key, value in jax_flat.items():
        if ".lora_" in key:
            continue
        want = transformer[cogview4_key_map(key)].numpy()
        assert np.array_equal(value.T if key.endswith(".kernel") and value.ndim == 2 else value, want), key
    assert isinstance(ours_vae.module, AutoencoderKL) and isinstance(jax_vae.module, JaxAutoencoderKL)
    vae_state = ours_vae.module.state_dict()
    assert vae_state.keys() == vae.keys() and all(torch.equal(vae_state[k], v) for k, v in vae.items())
    for key in ("latent_channels", "spatial_compression_ratio", "scaling_factor", "shift_factor"):
        assert ours_vae.config[key] == jax_vae.config[key], key
    assert (ours_vae.config["scaling_factor"], ours_vae.config["shift_factor"]) == (0.5, 0.125)
    assert isinstance(ours_te["text_encoder"], GlmHandle) and isinstance(jax_te["text_encoder"], FlaxGlmHandle)


def test_checkpoint_conditions_latents_and_request_match_jax(loaded, monkeypatch):
    port, transformer, vae, conditions = loaded["port"]
    ref, jax_transformer, jax_vae, jax_conditions = loaded["jax"]
    encoder, jax_encoder = conditions["text_encoder"], jax_conditions["text_encoder"]
    encoder.tokenizer = jax_encoder.tokenizer = StubTokenizer()
    got = port.prepare_conditions(caption="a cat on a mat", text_encoder=encoder)["encoder_hidden_states"]
    want = np.asarray(ref.prepare_conditions(caption="a cat on a mat", text_encoder=jax_encoder)["encoder_hidden_states"])
    assert got.shape == want.shape == (1, 16, 32)  # 7 ids left-padded to 16; the hash encoder pads to 1024
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    image = np.random.RandomState(3).uniform(-1, 1, (3, 16, 24)).astype(np.float32)
    moments = port.prepare_latents(vae, image=image)["latents"]
    want_moments = np.asarray(ref.prepare_latents(jax_vae, image=image)["latents"])
    assert moments.shape == want_moments.shape == (1, 8, 8, 12)
    np.testing.assert_allclose(moments.numpy(), want_moments, atol=TOL, rtol=TOL)
    z = np.random.RandomState(4).randn(1, 4, 8, 12).astype(np.float32)
    decoded = autoencoders.decode_image_vae(vae, torch.from_numpy(z))
    np.testing.assert_allclose(decoded.numpy(), np.asarray(jax_ae.decode_image_vae(jax_vae, jnp.asarray(z))),
                               atol=TOL, rtol=TOL)

    seen = {}
    jax_decode, port_decode = jax_ae.decode_image_vae, cogview4_pipeline.decode_image_vae
    monkeypatch.setattr(jax_ae, "decode_image_vae", lambda v, z: seen.setdefault("jax", np.asarray(z)) is not None
                        and jax_decode(v, z))
    monkeypatch.setattr(cogview4_pipeline, "decode_image_vae",
                        lambda v, z: seen.setdefault("port", z.numpy().copy()) is not None and port_decode(v, z))
    pipe = port.load_pipeline(transformer=transformer, vae=vae, text_encoder=encoder)
    jax_pipe = ref.load_pipeline(transformer=jax_transformer, vae=jax_vae, text_encoder=jax_encoder)
    assert pipe.text_encoder is encoder and isinstance(pipe.vae.module, AutoencoderKL)
    want_image = jax_pipe(**REQUEST)
    draw = np.array(jax.random.normal(jax.random.PRNGKey(REQUEST["seed"]), (1, 4, 8, 12), jnp.float32))
    image = pipe(**REQUEST, latents=torch.from_numpy(draw))
    np.testing.assert_allclose(seen["port"], seen["jax"], atol=TOL, rtol=TOL)
    assert image.shape == want_image.shape == (16, 24, 3)
    assert np.abs(image.astype(np.int16) - want_image.astype(np.int16)).max() <= 1


def test_runner_serves_the_checkpoint_with_its_tokenizer_flag(checkpoint, tmp_path, monkeypatch):
    """`python -m finetrainers_tpu_torch.inference --model_name cogview4` on the
    directory with `--tokenizer_id` (lifted for CogView4): a word-level
    tokenizer written here loads through transformers' `AutoTokenizer` into
    the loaded GLM, and a 16x24 image is written. A family without text
    towers (the dummy) keeps refusing the flag."""
    import cv2
    from tokenizers import Tokenizer, models, pre_tokenizers

    from finetrainers_tpu_torch import inference
    from finetrainers_tpu_torch.models.cogview4 import CogView4Pipeline

    root = checkpoint[0]
    words = sorted(set(REQUEST["prompt"].split()))
    tokenizer = Tokenizer(models.WordLevel({"<pad>": 0, "<unk>": 1, **{w: 2 + i for i, w in enumerate(words)}},
                                           unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    (tmp_path / "tokenizer").mkdir()
    tokenizer.save(str(tmp_path / "tokenizer" / "tokenizer.json"))
    (tmp_path / "tokenizer" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", "unk_token": "<unk>"}))
    seen = []
    call = CogView4Pipeline.__call__
    monkeypatch.setattr(CogView4Pipeline, "__call__", lambda self, **kw: seen.append(self.text_encoder) or call(self, **kw))
    argv = ["--model_name", "cogview4", "--pretrained_model_name_or_path", str(root), "--inference_type",
            "text_to_image", "--prompt", REQUEST["prompt"], "--height", "16", "--width", "24",
            "--num_inference_steps", "1", "--transformer_dtype", "fp32", "--vae_dtype", "fp32",
            "--text_encoder_dtype", "fp32", "--device", "cpu", "--output_dir", str(tmp_path / "out")]
    paths = inference.main(argv + ["--tokenizer_id", str(tmp_path / "tokenizer")], transformer_config=TINY)
    assert isinstance(seen[0], GlmHandle) and seen[0].tokenizer is not None
    assert cv2.imread(paths[0]).shape == (16, 24, 3)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        inference.main(["--model_name", "dummy"] + argv[2:] + ["--tokenizer_id", "t"])


@pytest.mark.parametrize("model,sub,item", [
    ("cogview4-control", "transformer", "finding 19"),
    ("wan-control", "transformer", "finding 19"),
])
def test_components_still_to_port_refuse_a_local_directory(model, sub, item, tmp_path):
    (tmp_path / sub).mkdir()
    (tmp_path / sub / "config.json").write_text("{}")
    name, training_type = (model[:-len("-control")], "control-lora") if model.endswith("-control") else (model, "lora")
    spec = get_model_specification_cls(name, training_type)(pretrained_model_name_or_path=str(tmp_path), device="meta")
    load = {"transformer": spec.load_diffusion_models, "vae": spec.load_latent_models,
            "text_encoder": spec.load_condition_models, "text_encoder_2": spec.load_condition_models}[sub]
    with pytest.raises(NotImplementedError, match=item):
        load()
