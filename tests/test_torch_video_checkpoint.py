"""Wan 2.1 and LTX-Video from a local diffusers directory, in both packages.

A tiny checkpoint per family is written here: `transformer/` (the port's
module, norms and biases drawn too, with its config.json), `vae/` (the
faithful `AutoencoderKLWan` with seeded latent statistics in its config, or
`AutoencoderKLLTXVideo`) and `text_encoder/` (a UMT5 or a gated-gelu T5
written by transformers' torch classes). Both specs load it: the base weights
equal the files', the LoRA factors are a fresh model's, each handle is the
tower's (not the hash encoder). `prepare_conditions` through the loaded tower
(one stub tokenizer), `prepare_latents` through the loaded VAE, and a 2-step
CFG request whose prompt the tower encodes and whose latents the VAE decodes
agree within 1e-4 in fp32 (the latents the VAE decodes; the uint8 videos
within one level). JAX's transformer init is drawn in numpy (`drawn_params`: an init
compile costs seconds); its checkpoint loading is the package's own. Then the runner serves
each directory with `--tokenizer_id`, CogVideoX's spec loads the T5, and the
components still to port keep refusing a local directory."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.ltx_video import LTXVideoModelSpecification as JaxLTXSpec
from finetrainers_tpu.models.ltx_video import LTXVideoTransformer3DModel as JaxLTX
from finetrainers_tpu.models.ltx_video.weights import load_ltx_transformer_params, ltx_key_map
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.wan import WanModelSpecification as JaxWanSpec
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu.models.wan.weights import load_wan_transformer_params, wan_key_map
from finetrainers_tpu.processors.text_encoders import FlaxT5Handle
from finetrainers_tpu_torch import get_model_specification_cls, inference
from finetrainers_tpu_torch.models.layers import init_parameters_
from finetrainers_tpu_torch.models.ltx_video import LTXVideoModelSpecification
from finetrainers_tpu_torch.models.ltx_video.transformer import LTXVideoTransformer3DModel
from finetrainers_tpu_torch.models.ltx_video.vae import AutoencoderKLLTXVideo, LTXVAEConfig
from finetrainers_tpu_torch.models.text_encoders import T5Handle
from finetrainers_tpu_torch.models.wan import WanModelSpecification
from finetrainers_tpu_torch.models.wan.transformer import WanTransformer3DModel
from finetrainers_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
from finetrainers_tpu_torch.processors import HashEncoder
from finetrainers_tpu_torch.utils.serialization import safetensors_save_dict
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)
TOL = 1e-4
RANK = 4
T5_DIMS = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4, relative_attention_num_buckets=8,
               relative_attention_max_distance=16, feed_forward_proj="gated-gelu")
FAMILIES = {
    "wan": dict(
        transformer=dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2,
                         attention_head_dim=64, num_layers=1, ffn_dim=48, text_dim=32, freq_dim=16),
        vae=dict(base_dim=8, z_dim=4, dim_mult=[1, 2, 2], num_res_blocks=1, temperal_downsample=[False, True],
                 latents_mean=[0.1, -0.2, 0.05, 0.3], latents_std=[0.9, 1.3, 0.7, 1.1]),
        request=dict(prompt="a red fox runs through fresh snow", height=16, width=24, num_frames=5,
                     num_inference_steps=2, guidance_scale=5.0, seed=0),
        video=(5, 16, 24), moments=(1, 8, 3, 4, 6)),
    "ltx_video": dict(
        transformer=dict(in_channels=4, out_channels=4, num_attention_heads=2, attention_head_dim=8,
                         cross_attention_dim=16, num_layers=1, caption_channels=32),
        vae=dict(latent_channels=4, block_out_channels=[8, 16], decoder_block_out_channels=[8, 16],
                 layers_per_block=[1, 1, 1], decoder_layers_per_block=[1, 1, 1],
                 spatio_temporal_scaling=[True, False], decoder_spatio_temporal_scaling=[True, False], patch_size=2),
        request=dict(prompt="a red fox runs through fresh snow", height=16, width=16, num_frames=5,
                     num_inference_steps=2, guidance_scale=3.0, seed=0),
        video=(5, 16, 16), moments=(1, 8, 3, 4, 4)),
}
PORT = {"wan": (WanModelSpecification, WanTransformer3DModel, AutoencoderKLWan, WanVAEConfig, "AutoencoderKLWan"),
        "ltx_video": (LTXVideoModelSpecification, LTXVideoTransformer3DModel, AutoencoderKLLTXVideo, LTXVAEConfig,
                      "AutoencoderKLLTXVideo")}
KEY_MAPS = {"wan": wan_key_map, "ltx_video": ltx_key_map}


class StubTokenizer:
    """One id per word (3, 4, ...), then EOS (1), padded with 0 to max_length and truncated."""

    pad_token_id = 0

    def __call__(self, texts, padding=None, max_length=None, truncation=None, return_tensors=None, **kw):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            row = [(j * 5) % 60 + 3 for j in range(len(t.split()))][:max_length - 1] + [1]
            ids[i, :len(row)] = row
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def _perturbed(module, seed):
    """`module`'s random state with its 1-D parameters (norms, biases) drawn as well."""
    init_parameters_(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1 or name.endswith("gamma"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return {k: v.contiguous() for k, v in module.state_dict().items()}


def _write_t5(path, umt5):
    from transformers import T5Config, T5EncoderModel, UMT5Config, UMT5EncoderModel

    torch.manual_seed(3)
    model = UMT5EncoderModel(UMT5Config(**T5_DIMS)) if umt5 else T5EncoderModel(T5Config(**T5_DIMS))
    model.eval().save_pretrained(path, safe_serialization=True)


def _write(path, config, state):
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(config))
    safetensors_save_dict(state, str(path / "diffusion_pytorch_model.safetensors"))


@pytest.fixture(scope="module", params=list(FAMILIES))
def checkpoint(request, tmp_path_factory):
    """(family, root, the transformer's and the VAE's written states)."""
    family = request.param
    fam, (_, transformer_cls, vae_cls, vae_config_cls, vae_name) = FAMILIES[family], PORT[family]
    root = tmp_path_factory.mktemp(family)
    transformer = _perturbed(transformer_cls(**fam["transformer"], dtype=torch.float32), 0)
    _write(root / "transformer", dict(fam["transformer"], _class_name=transformer_cls.__name__), transformer)
    vae = _perturbed(vae_cls(vae_config_cls.from_hf(fam["vae"]), torch.float32), 2)
    _write(root / "vae", dict(fam["vae"], _class_name=vae_name), vae)
    _write_t5(root / "text_encoder", umt5=family == "wan")
    (root / "model_index.json").write_text("{}")
    return family, root, transformer, vae


def _jax_spec(family, root):
    """JAX's spec with its transformer init drawn (`drawn_params`); the checkpoint loads through its own path."""
    cfg = FAMILIES[family]["transformer"]
    if family == "wan":
        class Spec(JaxWanSpec):
            def load_diffusion_models(self):
                module = JaxWan(**self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                                dtype=self.transformer_dtype)
                params = drawn_params(module, jnp.zeros((1, 4, 1, 4, 4)),
                                      jnp.zeros((1, 8, 32)), jnp.zeros((1,)))
                params = self._maybe_load_pretrained_transformer(params, load_wan_transformer_params, module=module)
                return {"transformer": JaxHandle(module, params, dict(self.transformer_config))}
    else:
        class Spec(JaxLTXSpec):
            def load_diffusion_models(self):
                module = JaxLTX(**self.transformer_config, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                                dtype=self.transformer_dtype)
                params = drawn_params(module, jnp.zeros((1, 8, 4)), jnp.zeros((1, 16, 32)),
                                      jnp.zeros((1,)), num_frames=2, height=2, width=2)
                params = self._maybe_load_pretrained_transformer(params, load_ltx_transformer_params, module=module)
                return {"transformer": JaxHandle(module, params, dict(self.transformer_config))}
    return Spec(pretrained_model_name_or_path=str(root), transformer_config=cfg, lora_rank=RANK, lora_alpha=RANK,
                transformer_dtype=jnp.float32, vae_dtype=jnp.float32)


@pytest.fixture(scope="module")
def loaded(checkpoint):
    """Both specs on the checkpoint and what each loads: {side: (spec, transformer, vae, condition models)}."""
    family, root = checkpoint[:2]
    port = PORT[family][0](pretrained_model_name_or_path=str(root), transformer_config=FAMILIES[family]["transformer"],
                           device="cpu", lora_rank=RANK, lora_alpha=RANK, transformer_dtype=torch.float32,
                           vae_dtype=torch.float32, text_encoder_dtype=torch.float32)
    ref = _jax_spec(family, root)
    return {side: (spec, spec.load_diffusion_models()["transformer"], spec.load_latent_models()["vae"],
                   spec.load_condition_models()) for side, spec in (("port", port), ("jax", ref))}


def test_checkpoint_loads_as_written_in_both_packages(checkpoint, loaded):
    family, _, transformer, vae = checkpoint
    spec, handle, ours_vae, ours_te = loaded["port"]
    _, jax_handle, jax_vae, jax_te = loaded["jax"]
    state = handle.module.state_dict()
    lora = {k: v for k, v in state.items() if ".lora_" in k}
    assert lora and all(torch.equal(state[k], v) for k, v in transformer.items())
    fresh = PORT[family][0](transformer_config=FAMILIES[family]["transformer"], device="cpu", lora_rank=RANK,
                            lora_alpha=RANK, transformer_dtype=torch.float32).load_diffusion_models()["transformer"]
    fresh_state = fresh.module.state_dict()
    assert all(torch.equal(v, fresh_state[k]) for k, v in lora.items())
    for key, value in flatten_params(jax_handle.params).items():
        if ".lora_" in key:
            continue
        value = np.asarray(value)
        want = transformer[KEY_MAPS[family](key)].numpy()
        assert np.array_equal(value.T if key.endswith(".kernel") and value.ndim == 2 else value, want), key
    assert isinstance(ours_vae.module, PORT[family][2]) and type(jax_vae.module).__name__ == PORT[family][4]
    vae_state = ours_vae.module.state_dict()
    assert vae_state.keys() == vae.keys() and all(torch.equal(vae_state[k], v) for k, v in vae.items())
    for key in ("latent_channels", "spatial_compression_ratio", "temporal_compression_ratio", "scaling_factor",
                "latents_mean", "latents_std"):
        np.testing.assert_array_equal(ours_vae.config[key], jax_vae.config[key], err_msg=key)
    if family == "wan":
        np.testing.assert_allclose(ours_vae.config["latents_std"], [0.9, 1.3, 0.7, 1.1], rtol=1e-6)
    else:
        assert (spec.vae_spatial_compression_ratio, spec.vae_temporal_compression_ratio) == (4, 2)
    assert isinstance(ours_te["text_encoder"], T5Handle) and isinstance(jax_te["text_encoder"], FlaxT5Handle)
    assert ours_te["text_encoder"].config.model_type == ("umt5" if family == "wan" else "t5")


def test_checkpoint_conditions_latents_and_request_match_jax(checkpoint, loaded):
    family = checkpoint[0]
    fam = FAMILIES[family]
    port, transformer, vae, conditions = loaded["port"]
    ref, jax_transformer, jax_vae, jax_conditions = loaded["jax"]
    encoder, jax_encoder = conditions["text_encoder"], jax_conditions["text_encoder"]
    encoder.tokenizer = jax_encoder.tokenizer = StubTokenizer()
    got = port.prepare_conditions(caption="a cat on a mat", text_encoder=encoder)
    want = ref.prepare_conditions(caption="a cat on a mat", text_encoder=jax_encoder)
    slots = 512 if family == "wan" else 128
    assert got["encoder_hidden_states"].shape == (1, slots, 32) and got["encoder_attention_mask"].sum() == 6
    np.testing.assert_array_equal(got["encoder_attention_mask"], np.asarray(want["encoder_attention_mask"]))
    np.testing.assert_allclose(got["encoder_hidden_states"], np.asarray(want["encoder_hidden_states"]), atol=TOL,
                               rtol=TOL)

    video = np.random.RandomState(3).uniform(-1, 1, (fam["video"][0], 3, *fam["video"][1:])).astype(np.float32)
    latents = port.prepare_latents(vae, video=video)
    want_latents = ref.prepare_latents(jax_vae, video=video)
    assert latents["latents"].shape == np.asarray(want_latents["latents"]).shape == fam["moments"]
    np.testing.assert_allclose(latents["latents"].numpy(), np.asarray(want_latents["latents"]), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(latents["latents_std"], want_latents["latents_std"])

    seen = {}
    port_decode, jax_apply = vae.module.decode, jax_vae.apply
    vae.module.decode = lambda z: seen.setdefault("port", z.numpy().copy()) is not None and port_decode(z)
    jax_vae.apply = lambda z, **kw: seen.setdefault("jax", np.asarray(z)) is not None and jax_apply(z, **kw)
    try:
        pipe = port.load_pipeline(transformer=transformer, vae=vae, text_encoder=encoder)
        jax_pipe = ref.load_pipeline(transformer=jax_transformer, vae=jax_vae, text_encoder=jax_encoder)
        assert pipe.text_encoder is encoder and pipe.vae is vae
        request = fam["request"]
        want_video = jax_pipe(**request)
        shape = pipe.latent_shape(request["num_frames"], request["height"], request["width"])
        draw = np.array(jax.random.normal(jax.random.PRNGKey(request["seed"]), shape, jnp.float32))
        got_video = pipe(**request, latents=torch.from_numpy(draw))
    finally:
        vae.module.decode, jax_vae.apply = port_decode, jax_apply
    np.testing.assert_allclose(seen["port"], seen["jax"], atol=TOL, rtol=TOL)
    assert got_video.shape == want_video.shape == (*fam["video"], 3)
    assert np.abs(got_video.astype(np.int16) - want_video.astype(np.int16)).max() <= 1


def test_runner_serves_the_checkpoint_with_its_tokenizer_flag(checkpoint, tmp_path, monkeypatch):
    """`python -m finetrainers_tpu_torch.inference` on the directory with
    `--tokenizer_id` (lifted for Wan and LTX-Video): a word-level tokenizer
    written here loads through transformers' `AutoTokenizer` into the loaded
    T5, and the video is written at the request's size."""
    import cv2
    from tokenizers import Tokenizer, models, pre_tokenizers

    family, root = checkpoint[:2]
    request = FAMILIES[family]["request"]
    words = sorted(set(request["prompt"].split()))
    tokenizer = Tokenizer(models.WordLevel({"<pad>": 0, "</s>": 1, "<unk>": 2,
                                            **{w: 3 + i for i, w in enumerate(words)}}, unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    (tmp_path / "tokenizer").mkdir()
    tokenizer.save(str(tmp_path / "tokenizer" / "tokenizer.json"))
    (tmp_path / "tokenizer" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", "unk_token": "<unk>",
         "eos_token": "</s>"}))
    spec_cls = PORT[family][0]
    seen = []
    load = spec_cls.load_condition_models
    monkeypatch.setattr(spec_cls, "load_condition_models", lambda self: seen.append(load(self)) or seen[-1])
    argv = ["--model_name", family, "--pretrained_model_name_or_path", str(root), "--tokenizer_id",
            str(tmp_path / "tokenizer"), "--inference_type", "text_to_video", "--prompt", request["prompt"],
            "--height", str(request["height"]), "--width", str(request["width"]), "--num_frames",
            str(request["num_frames"]), "--num_inference_steps", "1", "--transformer_dtype", "fp32", "--vae_dtype",
            "fp32", "--text_encoder_dtype", "fp32", "--device", "cpu", "--output_dir", str(tmp_path / "out")]
    paths = inference.main(argv, transformer_config=FAMILIES[family]["transformer"])
    encoder = seen[0]["text_encoder"]
    assert isinstance(encoder, T5Handle) and encoder.tokenizer is not None
    frames = cv2.VideoCapture(paths[0])
    ok, frame = frames.read()
    assert ok and frame.shape == (request["height"], request["width"], 3)


def test_cogvideox_spec_loads_t5(tmp_path):
    """CogVideoX's `text_encoder/` loads through `T5Handle` (JAX :74-87) and
    encodes its 226 slots (its VAE and transformer: test_torch_family_checkpoints.py)."""
    from finetrainers_tpu_torch.models.cogvideox import CogVideoXModelSpecification

    _write_t5(tmp_path / "text_encoder", umt5=False)
    spec = CogVideoXModelSpecification(pretrained_model_name_or_path=str(tmp_path), device="cpu",
                                       text_encoder_dtype=torch.float32)
    encoder = spec.load_condition_models()["text_encoder"]
    assert isinstance(encoder, T5Handle)
    encoder.tokenizer = StubTokenizer()
    conds = spec.prepare_conditions(caption="a cat", text_encoder=encoder)
    assert conds["encoder_hidden_states"].shape == (1, 226, 32) and conds["encoder_attention_mask"].sum() == 3
    ref = FlaxT5Handle(str(tmp_path))
    ref.tokenizer = StubTokenizer()
    np.testing.assert_allclose(encoder.encode(["a cat"], 226)[0], np.asarray(ref.encode(["a cat"], 226)[0]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["wan_i2v_image_encoder", "wan_control_transformer", "tower_without_weights",
                                  "vae_without_weights"])
def test_remaining_refusals_and_fallbacks(case, tmp_path):
    """Wan I2V's CLIP-vision `image_encoder/` and the control spec's transformer
    still raise; a `text_encoder/` whose weights are missing falls back to the
    hash encoder, as JAX's handle does; a `vae/` with a config and no weights
    gives the faithful VAE at random with the config's statistics, as JAX's
    `_load_video_vae` does."""
    sub = {"wan_i2v_image_encoder": "image_encoder", "wan_control_transformer": "transformer",
           "tower_without_weights": "text_encoder", "vae_without_weights": "vae"}[case]
    (tmp_path / sub).mkdir()
    (tmp_path / sub / "config.json").write_text(json.dumps(FAMILIES["wan"]["vae"] if sub == "vae" else {}))
    if case == "vae_without_weights":
        spec = WanModelSpecification(pretrained_model_name_or_path=str(tmp_path), device="cpu")
        vae = spec.load_latent_models()["vae"]
        assert isinstance(vae.module, AutoencoderKLWan) and vae.module.decoder.conv_out.weight.std() > 0
        np.testing.assert_allclose(vae.config["latents_std"], FAMILIES["wan"]["vae"]["latents_std"], rtol=1e-6)
    elif case == "wan_i2v_image_encoder":
        spec = WanModelSpecification(pretrained_model_name_or_path=str(tmp_path), device="meta",
                                     transformer_config={"image_dim": 1280, "in_channels": 36})
        with pytest.raises(NotImplementedError, match="CLIP-vision"):
            spec.load_condition_models()
    elif case == "wan_control_transformer":
        spec = get_model_specification_cls("wan", "control-lora")(pretrained_model_name_or_path=str(tmp_path),
                                                                  device="meta")
        with pytest.raises(NotImplementedError, match="finding 19"):
            spec.load_diffusion_models()
    else:
        for family in ("wan", "ltx_video"):
            spec = PORT[family][0](pretrained_model_name_or_path=str(tmp_path), device="cpu")
            assert isinstance(spec.load_condition_models()["text_encoder"], HashEncoder)
