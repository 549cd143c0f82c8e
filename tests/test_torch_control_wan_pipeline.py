"""The Wan pipeline's control branch against JAX's, and the runner's frame
conditioning.

A tiny Wan control model (test_torch_control_wan.py's, 8 input channels)
serves a 5x16x24 request with CFG 5.0 and 2 Euler steps and a uint8 control
video (or a control image as one frame), resized and cropped, encoded,
normalised with non-trivial latent statistics (both halves, the Wan quirk),
its posterior mean masked by the frame-conditioning type: `full` (what the
runner serves with, having no flag for it) and `index`. JAX's initial draw
is handed over; the uint8 videos agree within 1 level with 99% equal.

The training side's control media: a folder dataset's paired `control_video`
column (the port's addition; JAX's folder datasets drop it) reaches the
spec's `prepare_latents` through the port's data stage as the same control
moments that JAX's spec gives for the file decoded and handed to it.
"""

import csv
import functools
import importlib.util
import pathlib

import cv2

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetrainers_tpu.models.autoencoders import AutoencoderConfig as JaxVAEConfig
from finetrainers_tpu.data.utils import load_video as jax_load_video
from finetrainers_tpu.functional.video import resize_crop_video as jax_resize_crop_video
from finetrainers_tpu.models.autoencoders import AutoencoderKL3D as JaxVAE
from finetrainers_tpu.models.modeling_utils import ModelHandle
from finetrainers_tpu.models.wan.control_specification import WanControlModelSpecification as JaxControlSpec
from finetrainers_tpu.processors import HashEncoder as JaxHashEncoder
from finetrainers_tpu_torch import inference
from finetrainers_tpu_torch.data.dataset import initialize_dataset, wrap_iterable_dataset_for_preprocessing
from finetrainers_tpu_torch.models.autoencoders import AutoencoderConfig, load_flax_vae_params
from finetrainers_tpu_torch.models.wan import WanControlModelSpecification, load_flax_params
from finetrainers_tpu_torch.processors import HashEncoder
from finetrainers_tpu_torch.trainer.control_trainer import IterableControlDataset
from finetrainers_tpu_torch.trainer.sft_trainer.trainer import _process_latent
from test_torch_control_wan import MEAN, STD, TINY, _flat, jax_params, unflatten
from test_torch_video_vaes import drawn_params

torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
_runner_spec = importlib.util.spec_from_file_location("jax_inference_runner_wan_control",
                                                      REPO_ROOT / "examples/inference/inference.py")
jax_runner = importlib.util.module_from_spec(_runner_spec)
_runner_spec.loader.exec_module(jax_runner)

VAE_KW = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1, spatial_downsample=(True,),
              temporal_downsample=(True,))
REQUEST = dict(prompt="a sailboat drifting across a calm bay", height=16, width=24, num_frames=5,
               num_inference_steps=2, guidance_scale=5.0, seed=0)


@functools.lru_cache(maxsize=None)
def _jax_vae():
    module = JaxVAE(JaxVAEConfig(**VAE_KW), dtype=jnp.float32)
    params = drawn_params(module, jnp.zeros((1, 3, 1, 2, 2)))
    return module, params


def _vae_config():
    return {"latent_channels": 4, "spatial_compression_ratio": 2, "temporal_compression_ratio": 2,
            "latents_mean": MEAN, "latents_std": STD}


def control_video():
    rng = np.random.RandomState(4)
    coarse = (rng.rand(5, 4, 6, 3) * 255).astype(np.uint8)
    return np.stack([np.repeat(np.repeat(f, 4, axis=0), 4, axis=1) for f in coarse])


@pytest.mark.parametrize("ftype,media", [("full", "video"), ("index", "video"), ("full", "image")])
def test_wan_pipeline_control_branch_matches_jax(ftype, media):
    module, flat = jax_params(8, lora_rank=0)
    vae_module, vae_params = _jax_vae()
    spec = JaxControlSpec(transformer_config=TINY, vae_config=JaxVAEConfig(**VAE_KW), frame_conditioning_type=ftype)
    spec.transformer_dtype = spec.vae_dtype = jnp.float32
    jax_pipe = spec.load_pipeline(transformer=ModelHandle(module, unflatten(flat), dict(TINY, in_channels=8)),
                                  vae=ModelHandle(vae_module, vae_params, _vae_config()),
                                  text_encoder=JaxHashEncoder(hidden_size=32, max_length=16))
    control = {"control_video": control_video()} if media == "video" else {"control_image": control_video()[2]}
    ref = jax_pipe(**REQUEST, **control)
    port_spec = WanControlModelSpecification(transformer_config=TINY, vae_config=AutoencoderConfig(**VAE_KW),
                                             device="cpu", transformer_dtype=torch.float32, vae_dtype=torch.float32,
                                             frame_conditioning_type=ftype)
    transformer = port_spec.load_diffusion_models(new_in_features=8)["transformer"]
    load_flax_params(transformer.module, flat)
    vae = port_spec.load_latent_models()["vae"]
    load_flax_vae_params(vae.module, _flat(vae_params))
    vae.config.update(latents_mean=MEAN, latents_std=STD)
    pipe = port_spec.load_pipeline(transformer=transformer, vae=vae,
                                   text_encoder=HashEncoder(hidden_size=32, max_length=16))
    shape = pipe.latent_shape(REQUEST["num_frames"], REQUEST["height"], REQUEST["width"])
    draw = np.array(jax.random.normal(jax.random.PRNGKey(REQUEST["seed"]), shape, jnp.float32))
    video = pipe(**REQUEST, **control, latents=torch.from_numpy(draw))
    assert video.shape == ref.shape == (5, 16, 24, 3) and video.dtype == np.uint8
    diff = np.abs(video.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    with pytest.raises(ValueError, match="input channels"):  # a control model needs the control
        pipe(**REQUEST)


def test_runner_serves_with_the_full_type_as_jax():
    """ROADMAP.md section 3: the runner has no `--frame_conditioning_type`, so
    a control checkpoint trained with the example's `index` is served with the
    spec's default `full`, in both packages."""
    argv = ["--model_name", "wan", "--pretrained_model_name_or_path", "ckpt", "--training_type", "control-lora",
            "--prompt", "p"]
    port = inference.Inference(inference.parse_args(argv + ["--device", "cpu"]))
    ref = jax_runner.Inference(jax_runner.parse_args(argv))
    assert isinstance(port.spec, WanControlModelSpecification)
    assert port.spec.frame_conditioning_type == ref.spec.frame_conditioning_type == "full"
    assert port.spec.frame_conditioning_concatenate_mask is ref.spec.frame_conditioning_concatenate_mask is False


def test_folder_control_column_reaches_prepare_latents_as_jax_given_the_video(tmp_path):
    """`--control_type none` (the image_condition example): the control video
    comes only from the dataset's `control_video` column. Through the port's
    folder dataset, bucket resize, `IterableControlDataset` and the SFT data
    stage's `_process_latent`, the control moments equal (atol 1e-4, fp32)
    JAX's `prepare_latents` given the same file decoded, cropped to the
    sample's 16x24 and cut to its 5 frames."""
    rng = np.random.RandomState(5)
    for name in ("clip", "control"):  # 20x32 frames: the bucket's resize and crop do work
        writer = cv2.VideoWriter(str(tmp_path / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (32, 20))
        for frame in (rng.rand(7, 5, 8, 3) * 255).astype(np.uint8):
            writer.write(cv2.resize(frame, (32, 20), interpolation=cv2.INTER_LINEAR))
        writer.release()
    with open(tmp_path / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_name", "caption", "control_video"])
        w.writeheader()
        w.writerow({"file_name": "clip.mp4", "caption": "a sailboat", "control_video": "control.mp4"})
    data = wrap_iterable_dataset_for_preprocessing(initialize_dataset(str(tmp_path), "video"), "video",
                                                   {"video_resolution_buckets": [(5, 16, 24)]})
    sample = next(iter(IterableControlDataset(data, control_type="none")))
    port_spec = WanControlModelSpecification(transformer_config=TINY, vae_config=AutoencoderConfig(**VAE_KW),
                                             device="cpu", vae_dtype=torch.float32)
    vae = port_spec.load_latent_models()["vae"]
    vae_module, vae_params = _jax_vae()
    load_flax_vae_params(vae.module, _flat(vae_params))
    got = _process_latent(port_spec, vae, **sample)["control_latents"]

    control = jax_resize_crop_video(jax_load_video(str(tmp_path / "control.mp4")), (16, 24))[:5]
    spec = JaxControlSpec(transformer_config=TINY, vae_config=JaxVAEConfig(**VAE_KW))
    ref = spec.prepare_latents(ModelHandle(vae_module, vae_params, _vae_config()), video=sample["video"],
                               control_video=control)["control_latents"]
    assert got.shape == ref.shape == (1, 8, 3, 8, 12)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
