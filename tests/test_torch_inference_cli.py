"""The port's inference runner (`python -m finetrainers_tpu_torch.inference`)
against the JAX package's (`examples/inference/inference.py`).

- The parser: every flag and default of JAX's `parse_args`, and the same
  values for an argv that sets every flag off its default; the port adds only
  `--device`.
- A tiny Wan request through each runner's `main`-level entry (`Inference(args).run()`
  for JAX, `inference.main(argv, **spec_kwargs)` for the port), T2V and I2V
  (a PNG written with cv2, UniPC read from a scheduler config in `tmp_path`),
  the I2V request with `--lora_weights` (an adapter the port's trainer
  exported after one step, `--lora_scale 0.5`). Both runners build the tiny spec (2
  blocks, 2 heads of 64, a VAE of 8-16 channels, fp32); the port gets JAX's
  transformer and VAE weights through the bridge and JAX's initial draw
  `jax.random.normal(PRNGKey(seed), shape)` (JAX's offline model loaders are
  replaced by the same inits drawn by `drawn_params`: eager flax init costs ~40 s here). The
  uint8 videos the pipelines
  return must agree within 1 level with at least 99% of values equal (fp32
  sums in another order can move a value across a rounding boundary of the
  final `* 255` cast); both write one .mp4 and a manifest.
- An LTX T2V request through the port's runner writes its video.
- Each flag whose feature the port lacks raises NotImplementedError naming
  ROADMAP.md, before any model is built.
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
from finetrainers_tpu.models.modeling_utils import ModelHandle as JaxHandle
from finetrainers_tpu.models.modeling_utils import flatten_params
from finetrainers_tpu.models.wan import WanModelSpecification as JaxSpec
from finetrainers_tpu.models.wan import WanTransformer3DModel as JaxWan
from finetrainers_tpu.models.wan.pipeline import WanPipeline as JaxWanPipeline
from finetrainers_tpu.schedulers import FlowMatchEulerScheduler as JaxScheduler
from finetrainers_tpu_torch import inference
from finetrainers_tpu_torch.args import BaseArgs
from finetrainers_tpu_torch.lora import load_lora_weights
from finetrainers_tpu_torch.models import autoencoders
from finetrainers_tpu_torch.models.wan import WanModelSpecification, load_flax_params
from finetrainers_tpu_torch.models.wan.pipeline import WanPipeline
from finetrainers_tpu_torch.trainer import SFTTrainer
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
_runner_spec = importlib.util.spec_from_file_location("jax_inference_runner",
                                                      REPO_ROOT / "examples/inference/inference.py")
jax_runner = importlib.util.module_from_spec(_runner_spec)
_runner_spec.loader.exec_module(jax_runner)

T2V = dict(in_channels=4, out_channels=4, patch_size=(1, 2, 2), num_attention_heads=2, attention_head_dim=64,
           num_layers=2, ffn_dim=48, text_dim=32, freq_dim=16)
I2V = dict(T2V, in_channels=10, image_dim=24)
VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, spatial_downsample=(True,),
              temporal_downsample=(True,))
REQUEST = ["--height", "16", "--width", "24", "--num_frames", "5", "--num_inference_steps", "3",
           "--guidance_scale", "5.0", "--seed", "3", "--transformer_dtype", "fp32", "--vae_dtype", "fp32"]
REQUIRED = ["--model_name", "wan", "--pretrained_model_name_or_path", "ckpt"]


def test_parser_has_every_flag_and_default_of_jax():
    ref, out = vars(jax_runner.parse_args(REQUIRED)), vars(inference.parse_args(REQUIRED))
    assert out.pop("device") == "cuda"
    assert out == ref
    every = REQUIRED + [
        "--revision", "r", "--cache_dir", "c", "--tokenizer_id", "t", "--tokenizer_2_id", "t2", "--tokenizer_3_id",
        "t3", "--text_encoder_id", "e", "--text_encoder_2_id", "e2", "--text_encoder_3_id", "e3", "--transformer_id",
        "tr", "--vae_id", "v", "--text_encoder_dtype", "fp32", "--text_encoder_2_dtype", "fp16",
        "--text_encoder_3_dtype", "fp32", "--transformer_dtype", "fp16", "--vae_dtype", "fp32", "--enable_slicing",
        "--enable_tiling", "--quantize_int8", "--lora_weights", "l", "--lora_scale", "0.5", "--training_type",
        "control-lora", "--frame_conditioning_concatenate_mask", "--inference_type", "image_to_video",
        "--dataset_file", "d.csv", "--prompt", "p", "--negative_prompt", "n", "--image_path", "i.png",
        "--control_image_path", "ci.png", "--control_video_path", "cv.mp4", "--height", "480", "--width", "832",
        "--num_frames", "81", "--frame_rate", "16", "--num_inference_steps", "40", "--guidance_scale", "6.5",
        "--num_videos_per_prompt", "2", "--parallel_backend", "accelerate", "--pp_degree", "2", "--dp_degree", "3",
        "--dp_shards", "4", "--cp_degree", "5", "--tp_degree", "6", "--attn_provider", "sage", "--seed", "9",
        "--output_dir", "o", "--tracker_name", "tn", "--report_to", "jsonl", "--verbose", "2"]
    ref, out = vars(jax_runner.parse_args(every)), vars(inference.parse_args(every + ["--device", "cpu"]))
    assert out.pop("device") == "cpu"
    assert out == ref
    assert all(ref[k] != v for k, v in vars(jax_runner.parse_args(REQUIRED)).items()
               if k not in ("model_name", "pretrained_model_name_or_path"))


class _TinyJaxWan(JaxSpec):
    """JAX's Wan spec at the tiny config, in fp32 (the runner passes no config)."""

    config = T2V

    def __init__(self, **kwargs):
        kwargs.pop("transformer_dtype", None), kwargs.pop("vae_dtype", None)
        super().__init__(transformer_config=self.config, vae_config=jax_ae.AutoencoderConfig(**VAE_KW), **kwargs)
        self.transformer_dtype = self.vae_dtype = jnp.float32


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(params)).items()}


@functools.lru_cache(maxsize=None)
def _jax_vae():
    """The tiny VAE's module and its init (`drawn_params`), made once per process."""
    cfg = jax_ae.AutoencoderConfig(**VAE_KW)
    module = jax_ae.AutoencoderKL3D(cfg, dtype=jnp.float32)
    ratio = cfg.spatial_compression_ratio
    return module, drawn_params(module, jnp.zeros((1, 3, 1, ratio, ratio)))


def _run_both(tmp_path, monkeypatch, config, argv):
    """The same argv through JAX's runner and the port's; returns (JAX video,
    port video, the port's written paths). The port loads the weights JAX's
    spec built and JAX's initial draw."""
    monkeypatch.setattr(_TinyJaxWan, "config", config)
    monkeypatch.setattr(jax_config, "_get_model_specifiction_cls", lambda name, training_type: _TinyJaxWan)
    built, videos = {}, {}
    jax_call, port_call = JaxWanPipeline.__call__, WanPipeline.__call__
    port_load_diffusion, port_load_latent = WanModelSpecification.load_diffusion_models, \
        WanModelSpecification.load_latent_models

    def jax_diffusion(self):  # JAX's offline load_diffusion_models (:122-144) with its init drawn
        cfg = self.transformer_config
        module = JaxWan(**cfg, lora_rank=self.lora_rank, lora_alpha=self.lora_alpha, dtype=self.transformer_dtype)
        image = {"encoder_hidden_states_image": jnp.zeros((1, 4, cfg["image_dim"]))} if self.is_i2v else {}
        params = drawn_params(module, jnp.zeros((1, cfg["in_channels"], 1, 4, 4)),
                              jnp.zeros((1, 8, cfg["text_dim"])), jnp.zeros((1,)), **image)
        built["transformer"] = _flat(params)
        return {"transformer": JaxHandle(module, params, dict(cfg)), "scheduler": JaxScheduler(shift=3.0)}

    def jax_latent(self):  # JAX's offline load_latent_models (:101-120) with its init drawn
        cfg = self.vae_autoencoder_config
        module, params = _jax_vae()
        built["vae"] = _flat(params)
        return {"vae": JaxHandle(module, params, {
            "latent_channels": cfg.latent_channels, "spatial_compression_ratio": cfg.spatial_compression_ratio,
            "temporal_compression_ratio": cfg.temporal_compression_ratio,
            "latents_mean": np.zeros((cfg.latent_channels,), np.float32),
            "latents_std": np.ones((cfg.latent_channels,), np.float32)})}

    def port_diffusion(self):
        out = port_load_diffusion(self)
        load_flax_params(out["transformer"].module, built["transformer"])
        return out

    def port_latent(self):
        out = port_load_latent(self)
        autoencoders.load_flax_vae_params(out["vae"].module, built["vae"])
        return out

    def jax_pipeline_call(self, **kwargs):
        videos["jax"] = jax_call(self, **kwargs)
        return videos["jax"]

    def port_pipeline_call(self, **kwargs):
        shape = self.latent_shape(kwargs["num_frames"], kwargs["height"], kwargs["width"])
        draw = np.array(jax.random.normal(jax.random.PRNGKey(kwargs["seed"]), shape, jnp.float32))
        videos["port"] = port_call(self, **kwargs, latents=torch.from_numpy(draw))
        videos["lora_b"] = dict(self.transformer.module.named_parameters()).get("blocks.0.attn1.to_q.lora_B.weight")
        return videos["port"]

    monkeypatch.setattr(JaxSpec, "load_diffusion_models", jax_diffusion)
    monkeypatch.setattr(JaxSpec, "load_latent_models", jax_latent)
    monkeypatch.setattr(WanModelSpecification, "load_diffusion_models", port_diffusion)
    monkeypatch.setattr(WanModelSpecification, "load_latent_models", port_latent)
    monkeypatch.setattr(JaxWanPipeline, "__call__", jax_pipeline_call)
    monkeypatch.setattr(WanPipeline, "__call__", port_pipeline_call)
    jax_runner.Inference(jax_runner.parse_args(argv + ["--output_dir", str(tmp_path / "jax")])).run()
    paths = inference.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"],
                           transformer_config=config, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
    return videos["jax"], videos["port"], paths, videos["lora_b"]


def _assert_videos_agree(ref, video):
    assert video.shape == ref.shape == (5, 16, 24, 3) and video.dtype == np.uint8
    diff = np.abs(video.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def _checkpoint(tmp_path):
    root = tmp_path / "ckpt"
    (root / "scheduler").mkdir(parents=True)
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "UniPCMultistepScheduler", "flow_shift": 3.0, "solver_order": 2, "solver_type": "bh2"}))
    return str(root)


@pytest.fixture(scope="module")
def exported_adapter(tmp_path_factory):
    """The adapter the port's trainer exports after one step of the tiny I2V
    model (rank 4, lr 0.05, so the B factors are far from zero)."""
    out = tmp_path_factory.mktemp("trained")
    spec = WanModelSpecification(transformer_config=I2V, device="cpu", transformer_dtype=torch.float32)
    trainer = SFTTrainer(BaseArgs(training_type="lora", rank=4, lora_alpha=4, seed=0, lr=0.05,
                                  output_dir=str(out)), spec)
    trainer.prepare()
    rng = np.random.RandomState(0)
    moments = rng.randn(1, 8, 3, 8, 12).astype(np.float32)
    mask = np.zeros((1, 2, 3, 8, 12), np.float32)
    mask[:, :, 0] = 1
    batch = ({"encoder_hidden_states": torch.from_numpy(rng.randn(1, 16, 32).astype(np.float32)),
              "encoder_attention_mask": torch.ones(1, 16, dtype=torch.int32)},
             {"latents": torch.from_numpy(moments), "latent_condition": torch.from_numpy(moments.copy()),
              "latent_condition_mask": torch.from_numpy(mask), "latents_mean": torch.zeros(4),
              "latents_std": torch.ones(4)})
    trainer.train([batch])
    path = out / "lora_weights" / "000001"
    assert (path / "pytorch_lora_weights.safetensors").is_file()
    return str(path)


@pytest.mark.parametrize("kind,lora", [("t2v", False), ("i2v", True)], ids=["t2v", "i2v_lora"])
def test_request_through_main_matches_jax_runner(kind, lora, tmp_path, monkeypatch, request):
    argv = REQUIRED[:3] + [_checkpoint(tmp_path)] + REQUEST + ["--prompt", "a red fox in the snow"]
    if kind == "i2v":
        image = np.random.RandomState(8).randint(0, 256, (16, 24, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "first.png"), cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        argv += ["--inference_type", "image_to_video", "--image_path", str(tmp_path / "first.png")]
    if lora:
        adapter = request.getfixturevalue("exported_adapter")
        argv += ["--lora_weights", adapter, "--lora_scale", "0.5"]
    ref, video, paths, lora_b = _run_both(tmp_path, monkeypatch, I2V if kind == "i2v" else T2V, argv)
    _assert_videos_agree(ref, video)
    assert [pathlib.Path(p).name for p in paths] == ["output-0-0000-0.mp4"] and pathlib.Path(paths[0]).stat().st_size
    manifest = json.loads(next((tmp_path / "port").glob("manifest-*.json")).read_text())
    assert manifest == [{"type": "video", "path": paths[0], "caption": "a red fox in the snow"}]
    if lora:  # the adapter's factors at its rank, the B factors scaled by --lora_scale
        state, config = load_lora_weights(adapter)
        assert config["r"] == 4 and lora_b is not None
        want = state["transformer.blocks.0.attn1.to_q.lora_B.weight"]
        assert want.abs().max() > 1e-3 and torch.equal(lora_b, 0.5 * want)
    else:
        assert lora_b is None


def test_ltx_text_to_video_through_main(tmp_path):
    paths = inference.main(["--model_name", "ltx_video", "--pretrained_model_name_or_path", str(tmp_path / "none"),
                            "--prompt", "a fox", "--height", "16", "--width", "16", "--num_frames", "5",
                            "--num_inference_steps", "2", "--device", "cpu", "--output_dir", str(tmp_path / "out"),
                            "--num_videos_per_prompt", "2"],
                           transformer_config=dict(in_channels=4, out_channels=4, num_attention_heads=2,
                                                   attention_head_dim=8, cross_attention_dim=16, num_layers=2,
                                                   caption_channels=32),
                           vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
    assert [pathlib.Path(p).name for p in paths] == ["output-0-0000-0.mp4", "output-0-0000-1.mp4"]
    frames = cv2.VideoCapture(paths[0])
    assert int(frames.get(cv2.CAP_PROP_FRAME_COUNT)) == 5


def test_dataset_file_requests(tmp_path, monkeypatch):
    """JSONL and CSV request files: one video per row, the row's fields over the flags'."""
    calls = []
    monkeypatch.setattr(WanPipeline, "__call__", lambda self, **kw: calls.append(kw) or np.zeros((5, 16, 24, 3),
                                                                                                  np.uint8))
    rows = [{"caption": "one", "num_inference_steps": 2}, {"caption": "two", "num_inference_steps": 3}]
    (tmp_path / "r.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    (tmp_path / "r.csv").write_text("caption,num_inference_steps\none,2\ntwo,3\n")
    for name in ("r.jsonl", "r.csv", "r.json"):
        if name == "r.json":
            (tmp_path / name).write_text(json.dumps({"data": rows}))
        calls.clear()
        paths = inference.main(REQUIRED[:3] + [str(tmp_path)] + REQUEST + [
            "--dataset_file", str(tmp_path / name), "--device", "cpu", "--output_dir", str(tmp_path / name[2:])],
            transformer_config=T2V, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
        assert len(paths) == 2 and [c["prompt"] for c in calls] == ["one", "two"]
        assert calls[0]["num_inference_steps"] == 2 and calls[1]["num_inference_steps"] == 3, name


@pytest.mark.parametrize("extra", [
    ["--dp_degree", "2"], ["--tp_degree", "2"], ["--cp_degree", "2"], ["--dp_shards", "2"], ["--pp_degree", "2"],
    ["--dataset_file", "requests.parquet"], ["--revision", "main"], ["--tokenizer_id", "t", "--model_name", "dummy"],
], ids=lambda extra: extra[0].lstrip("-"))
def test_unported_flags_raise_naming_roadmap(extra, monkeypatch):
    monkeypatch.setattr(WanModelSpecification, "load_diffusion_models",
                        lambda self: pytest.fail("a model was built before the flag was refused"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        inference.main(REQUIRED + ["--prompt", "p", "--device", "cpu"] + extra)


def test_image_to_video_needs_an_image(tmp_path):
    with pytest.raises(ValueError, match="image"):
        inference.main(REQUIRED[:3] + [str(tmp_path)] + REQUEST + ["--prompt", "p", "--inference_type",
                                                                   "image_to_video", "--device", "cpu",
                                                                   "--output_dir", str(tmp_path / "o")],
                       transformer_config=I2V, vae_config=autoencoders.AutoencoderConfig(**VAE_KW))
