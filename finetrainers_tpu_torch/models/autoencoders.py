"""Causal 3D convolutional VAE (port of `finetrainers_tpu/models/autoencoders.py`).

The same configurable autoencoder the JAX package uses when no checkpoint of a
family's real VAE is present: temporally causal convolutions (frame t sees only
frames <= t, the front padded with copies of the first frame), per-frame
GroupNorm, and first-frame-preserving temporal down/upsampling. Layout is
NCDHW throughout (the JAX package runs NDHWC inside and NCDHW at its public
boundary). Module names equal the flax names, so `load_flax_vae_params` maps
a flattened flax tree onto the state dict by renaming only the leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import init_parameters_
from .modeling_utils import ModelHandle, ModelSpecification
from .weight_utils import load_torch_state


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    latent_channels: int = 128
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    # Per-stage downsampling flags; len == len(block_out_channels) - 1 entries used.
    spatial_downsample: Tuple[bool, ...] = (True, True, True)
    temporal_downsample: Tuple[bool, ...] = (True, True, True)
    in_channels: int = 3
    scaling_factor: float = 1.0

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** sum(self.spatial_downsample)

    @property
    def temporal_compression_ratio(self) -> int:
        return 2 ** sum(self.temporal_downsample)


LTX_VAE_CONFIG = AutoencoderConfig(
    latent_channels=128,
    block_out_channels=(128, 256, 512, 512, 512),
    layers_per_block=2,
    spatial_downsample=(True, True, True, True, True),
    temporal_downsample=(False, True, True, True, False),
)

# Copied from `finetrainers_tpu/models/autoencoders.py:306-312`.
WAN_VAE_CONFIG = AutoencoderConfig(
    latent_channels=16,
    block_out_channels=(96, 192, 384, 384),
    layers_per_block=2,
    spatial_downsample=(True, True, True),  # 8x spatial
    temporal_downsample=(False, True, True),  # 4x temporal
)


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax "SAME" padding: output ceil(size/stride), the extra pixel at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv3d(nn.Module):
    """Plain 3D convolution with its own parameters (flax `nn.Conv`); `same`
    selects flax's SAME padding, otherwise the input is used as it is."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3), stride=(1, 1, 1),
                 same: bool = False, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.same = same
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel_size, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_channels, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            self.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.same:
            pads = [_same_pads(n, k, s) for n, k, s in zip(x.shape[2:], self.kernel_size, self.stride)]
            x = F.pad(x, [p for pair in reversed(pads) for p in pair])
        return F.conv3d(x, self.weight, self.bias, stride=self.stride)


class CausalConv3d(nn.Module):
    """Temporal: causal (front padded with copies of frame 0); spatial: SAME."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3), stride=(1, 1, 1),
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, kernel_size, stride, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.conv.kernel_size
        if kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
        return self.conv(F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)))


class _GroupNormParams(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(channels, dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class GroupNorm(nn.Module):
    """Per-frame GroupNorm in fp32: statistics within each frame (time folded
    into batch), which keeps the VAE causal."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6) -> None:
        super().__init__()
        self.num_groups = min(num_groups, channels)
        self.eps = eps
        self.norm = _GroupNormParams(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        flat = x.transpose(1, 2).reshape(b * t, c, h, w).float()
        out = F.group_norm(flat, self.num_groups, self.norm.weight, self.norm.bias, self.eps)
        return out.reshape(b, t, c, h, w).transpose(1, 2).to(x.dtype)


class ResBlock3d(nn.Module):
    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = CausalConv3d(in_channels, features, dtype=dtype)
        self.norm2 = GroupNorm(features)
        self.conv2 = CausalConv3d(features, features, dtype=dtype)
        self.shortcut = Conv3d(in_channels, features, (1, 1, 1), dtype=dtype) if in_channels != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class Encoder3d(nn.Module):
    def __init__(self, config: AutoencoderConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        boc = cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], dtype=dtype)
        ch = boc[0]
        for i, features in enumerate(boc):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_block_{j}", ResBlock3d(ch, features, dtype))
                ch = features
            if i < len(boc) - 1:
                st = 2 if cfg.spatial_downsample[i] else 1
                tt = 2 if cfg.temporal_downsample[i] else 1
                if st > 1 or tt > 1:
                    self.add_module(f"down_{i}_downsample",
                                    CausalConv3d(ch, boc[i + 1], (3, 3, 3), (tt, st, st), dtype=dtype))
                    if tt > 1:
                        self.add_module(f"down_{i}_first_frame",
                                        Conv3d(ch, boc[i + 1], (1, st, st), (1, st, st), same=True, dtype=dtype))
                    ch = boc[i + 1]
        for j in range(cfg.layers_per_block):
            self.add_module(f"mid_block_{j}", ResBlock3d(ch, boc[-1], dtype))
            ch = boc[-1]
        self.norm_out = GroupNorm(ch)
        self.conv_out = CausalConv3d(ch, 2 * cfg.latent_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if hasattr(self, f"down_{i}_downsample"):
                down = getattr(self, f"down_{i}_downsample")
                if hasattr(self, f"down_{i}_first_frame"):
                    # Causal temporal stride: frame 0 keeps its own (1, s, s) conv.
                    first = getattr(self, f"down_{i}_first_frame")(h[:, :, :1])
                    h = torch.cat([first, down(h[:, :, 1:])], dim=2) if h.shape[2] > 1 else first
                else:
                    h = down(h)
        for j in range(cfg.layers_per_block):
            h = getattr(self, f"mid_block_{j}")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder3d(nn.Module):
    def __init__(self, config: AutoencoderConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        channels = list(reversed(cfg.block_out_channels))
        # Stage i upsamples by the reversed flags' i-th entry, for i < len - 1
        # (autoencoders.py:161-178): one flag of each list goes unused.
        self.up_spatial = list(reversed(cfg.spatial_downsample))
        self.up_temporal = list(reversed(cfg.temporal_downsample))
        self.conv_in = CausalConv3d(cfg.latent_channels, channels[0], dtype=dtype)
        for j in range(cfg.layers_per_block):
            self.add_module(f"mid_block_{j}", ResBlock3d(channels[0], channels[0], dtype))
        ch = channels[0]
        for i, features in enumerate(channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"up_{i}_block_{j}", ResBlock3d(ch, features, dtype))
                ch = features
            if i < len(channels) - 1 and (self.up_spatial[i] or self.up_temporal[i]):
                self.add_module(f"up_{i}_upsample", CausalConv3d(ch, channels[i + 1], dtype=dtype))
                ch = channels[i + 1]
        self.norm_out = GroupNorm(ch)
        self.conv_out = CausalConv3d(ch, cfg.in_channels, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.conv_in(z)
        for j in range(cfg.layers_per_block):
            h = getattr(self, f"mid_block_{j}")(h)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if hasattr(self, f"up_{i}_upsample"):
                if self.up_temporal[i]:
                    # Causal temporal upsample: the first frame stays single.
                    h = torch.cat([h[:, :, :1], h[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
                if self.up_spatial[i]:
                    h = h.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL3D(nn.Module):
    """Public boundary is NCDHW (B, C, T, H, W), as in the JAX package."""

    def __init__(self, config: AutoencoderConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = Encoder3d(config, dtype)
        self.decoder = Decoder3d(config, dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W) in [-1, 1] -> moments (B, 2*latent, T', H', W') fp32."""
        return self.encoder(x.to(self.dtype)).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z.to(self.dtype)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode(x).chunk(2, dim=1)
        return self.decode(mean)


def _encode(vae_handle: ModelHandle, x: torch.Tensor) -> torch.Tensor:
    return vae_handle.module.encode(x)


def encode_sliced(vae_handle: ModelHandle, x: torch.Tensor, slice_size: int = 1) -> torch.Tensor:
    """Batch-sliced encode (--enable_slicing): `slice_size` samples at a time
    (JAX autoencoders.py:212-221)."""
    if x.shape[0] <= slice_size:
        return _encode(vae_handle, x)
    return torch.cat([_encode(vae_handle, x[i:i + slice_size]) for i in range(0, x.shape[0], slice_size)])


def encode_tiled(vae_handle: ModelHandle, x: torch.Tensor, tile: int = 256, overlap: int = 32) -> torch.Tensor:
    """Spatially tiled encode (--enable_tiling; JAX autoencoders.py:224-249):
    `tile`-square patches every `tile - overlap` pixels, each encoded alone,
    their moments summed where they overlap and divided by the count."""
    b, _, _, h, w = x.shape
    if h <= tile and w <= tile:
        return _encode(vae_handle, x)
    ratio = vae_handle.config.get("spatial_compression_ratio", 8)
    stride = tile - overlap
    out = weight = None
    for y0 in range(0, max(h - overlap, 1), stride):
        for x0 in range(0, max(w - overlap, 1), stride):
            enc = _encode(vae_handle, x[:, :, :, y0:min(y0 + tile, h), x0:min(x0 + tile, w)])
            if out is None:
                lh, lw = h // ratio, w // ratio
                out = torch.zeros((b, enc.shape[1], enc.shape[2], lh, lw), dtype=enc.dtype, device=enc.device)
                weight = torch.zeros((1, 1, 1, lh, lw), dtype=enc.dtype, device=enc.device)
            ly0, lx0 = y0 // ratio, x0 // ratio
            out[:, :, :, ly0:ly0 + enc.shape[3], lx0:lx0 + enc.shape[4]] += enc
            weight[:, :, :, ly0:ly0 + enc.shape[3], lx0:lx0 + enc.shape[4]] += 1.0
    return out / weight.clamp_min(1.0)


@torch.no_grad()
def encode_media(vae_handle: ModelHandle, x: torch.Tensor, tile: int = 256, overlap: int = 32) -> torch.Tensor:
    """Encode (B, C, T, H, W) media in [-1, 1] -> fp32 moments, honouring the
    handle's `use_tiling` and `use_slicing` (JAX autoencoders.py:252-260)."""
    if vae_handle.use_tiling and (x.shape[-2] > tile or x.shape[-1] > tile):
        return encode_tiled(vae_handle, x, tile=tile, overlap=overlap)
    if vae_handle.use_slicing and x.shape[0] > 1:
        return encode_sliced(vae_handle, x)
    return _encode(vae_handle, x)


def media_to_vae_input(image, video, device: torch.device) -> torch.Tensor:
    """An image (C, H, W) or video (T, C, H, W) in [-1, 1] (numpy or tensor)
    -> the VAE's (1, C, T, H, W) fp32 input on `device`."""
    media = torch.as_tensor(video if video is not None else image[None])
    return media.to(device=device, dtype=torch.float32)[None].permute(0, 2, 1, 3, 4).contiguous()


def sample_from_moments(moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DiagonalGaussian sample (JAX :289-293): moments (B, 2C, ...) split into
    mean and log-variance on the channel axis; `noise` is the standard normal
    draw of the mean's shape, if given, else it comes from `generator`."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)


def generic_vae(spec: ModelSpecification, config: AutoencoderConfig, what: str) -> ModelHandle:
    """The generic `AutoencoderKL3D` with `config` on `spec`'s device, random
    weights from `spec.generator()`, identity latent statistics: the VAE the
    JAX package serves with when no checkpoint of the family's real VAE
    (`what`) exists."""
    spec._refuse_checkpoint(spec.vae_id, "vae", what)
    with torch.device(spec.device):
        module = AutoencoderKL3D(config, dtype=spec.vae_dtype)
    init_parameters_(module, spec.generator()).eval()
    return ModelHandle(module, {
        "latent_channels": config.latent_channels,
        "spatial_compression_ratio": config.spatial_compression_ratio,
        "temporal_compression_ratio": config.temporal_compression_ratio,
        # Per-channel stats (real values come with a checkpoint; identity here).
        "latents_mean": np.zeros((config.latent_channels,), np.float32),
        "latents_std": np.ones((config.latent_channels,), np.float32),
    })


def load_flax_vae_params(model: AutoencoderKL3D, flat_params: Dict[str, np.ndarray]) -> AutoencoderKL3D:
    """Load the JAX package's flattened `AutoencoderKL3D` parameters strict:
    conv kernels (kt, kh, kw, in, out) -> (out, in, kt, kh, kw), GroupNorm
    `norm.scale` -> `norm.weight`; biases unchanged."""
    state = {}
    for key, value in flat_params.items():
        base, leaf = key.rsplit(".", 1)
        value = np.asarray(value)
        if leaf == "kernel":
            state[f"{base}.weight"] = value.transpose(4, 3, 0, 1, 2)
        elif leaf == "scale":
            state[f"{base}.weight"] = value
        else:
            state[key] = value
    return load_torch_state(model, state)
