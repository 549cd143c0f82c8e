"""CogVideoX's causal 3D VAE, `AutoencoderKLCogVideoX` (port of
`finetrainers_tpu/models/cogvideox/vae.py:41-320`).

  - Causal convs (`causal_vae.CausalConv3d`: weights at `.conv`, kt - 1
    copies of frame 0 in front); `conv_shortcut` is a plain 1x1x1 conv with
    its weights on it (no `.conv` level).
  - GroupNorms take their fp32 statistics over the whole clip.
  - The decoder's norms are `CogVideoXSpatialNorm3D`: GroupNorm(f) *
    conv_y(zq) + conv_b(zq), zq (the latents) resized to f's size with
    half-pixel nearest sampling, its frame 0 alone onto f's frame 0 and frames
    1.. onto f's frames 1.. where both have more than one frame and their
    counts differ (`vae.py:102-114`).
  - The downsampler keeps frame 0 and averages frames 1.. in pairs where it
    compresses time (1 + 2k -> 1 + k), then pads right and bottom by one and
    convolves 3x3 with stride 2, frame by frame.
  - The upsampler doubles frames 1.. in time where it decompresses time (frame
    0 stays single), doubles rows and columns (nearest), then convolves 3x3
    SAME, frame by frame.
  - No quant or post-quant conv; 1 + 4k frames -> 1 + k latent frames, 8x in
    space.

Layout is NCDHW throughout (JAX runs NDHWC inside, NCDHW at its boundary).
Parameter names are those `cogvideox_vae_key_map` gives JAX's exporter
(`encoder.mid_block.resnets.{j}`, `decoder.up_blocks.{i}.upsamplers.0.conv`,
...), conv weights torch's (out, in, kt, kh, kw) and (out, in, kh, kw).
Past `autoencoders.SPLIT_ELEMENTS` every conv, norm and resample runs in
runs of frames (`causal_vae`), the SpatialNorm's zq resized run by run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..causal_vae import (CausalConv3d, ClipGroupNorm, ConvWeights, frame_step, nearest_indices, resize_frames_2d,
                          silu_post, upsampled_reader)


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    """Copied from `finetrainers_tpu/models/cogvideox/vae.py:41-68`."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426

    @classmethod
    def from_hf(cls, cfg: dict) -> "CogVideoXVAEConfig":
        return cls(
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg.get("latent_channels", 16),
            block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 256, 512))),
            layers_per_block=cfg.get("layers_per_block", 3),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            temporal_compression_ratio=cfg.get("temporal_compression_ratio", 4),
            scaling_factor=cfg.get("scaling_factor", 1.15258426),
        )

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def zq_frame_indices(zt: int, t: int, device: torch.device) -> torch.Tensor:
    """Which latent frame each of f's `t` frames reads (`vae.py:106-114`):
    frame 0 from frame 0 and frames 1.. resized from frames 1.. where both
    clips have more than one frame and their counts differ, else all `zt`
    frames resized to `t`."""
    if zt > 1 and t > 1 and t != zt:
        return torch.cat([torch.zeros(1, dtype=torch.long, device=device),
                          1 + nearest_indices(zt - 1, t - 1, device)])
    return nearest_indices(zt, t, device)


class CogSpatialNorm3D(nn.Module):
    """GroupNorm(f) * conv_y(zq) + conv_b(zq) (`vae.py:94-118`), with f's
    statistics over the whole clip and zq resized run by run."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.norm_layer = ClipGroupNorm(f_channels, groups)
        self.conv_y = CausalConv3d(zq_channels, f_channels, (1, 1, 1), dtype=dtype)
        self.conv_b = CausalConv3d(zq_channels, f_channels, (1, 1, 1), dtype=dtype)

    def forward(self, f: torch.Tensor, zq: torch.Tensor, silu: bool = False) -> torch.Tensor:
        src = zq_frame_indices(zq.shape[2], f.shape[2], f.device)

        def modulate(t0: int, t1: int, y: torch.Tensor) -> torch.Tensor:
            z = resize_frames_2d(zq.index_select(2, src[t0:t1]), f.shape[3:])
            out = y * self.conv_y.conv.pointwise(z) + self.conv_b.conv.pointwise(z)
            return F.silu(out) if silu else out

        return self.norm_layer(f, post=modulate)


class CogResnetBlock3D(nn.Module):
    """norm, SiLU, causal conv, norm, SiLU, causal conv, plus the (1x1x1 conv'd) input (`vae.py:121-147`);
    the norms are GroupNorms in the encoder and SpatialNorms (`spatial_norm_dim` set) in the decoder."""

    def __init__(self, in_dim: int, out_dim: int, groups: int, spatial_norm_dim: Optional[int],
                 dtype: torch.dtype) -> None:
        super().__init__()
        if spatial_norm_dim is None:
            self.norm1, self.norm2 = ClipGroupNorm(in_dim, groups), ClipGroupNorm(out_dim, groups)
        else:
            self.norm1 = CogSpatialNorm3D(in_dim, spatial_norm_dim, groups, dtype)
            self.norm2 = CogSpatialNorm3D(out_dim, spatial_norm_dim, groups, dtype)
        self.conv1 = CausalConv3d(in_dim, out_dim, dtype=dtype)
        self.conv2 = CausalConv3d(out_dim, out_dim, dtype=dtype)
        if in_dim != out_dim:
            self.conv_shortcut = ConvWeights(in_dim, out_dim, (1, 1, 1), dtype)

    def _norm_silu(self, norm: nn.Module, x: torch.Tensor, zq: Optional[torch.Tensor]) -> torch.Tensor:
        return norm(x, post=silu_post) if zq is None else norm(x, zq, silu=True)

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self._norm_silu(self.norm1, x, zq))
        h = self.conv2(self._norm_silu(self.norm2, h, zq))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut.pointwise(x)
        return h.add_(x)


def _per_frame_2d(read, shape, fn, elements: int, out_channels: int) -> torch.Tensor:
    """`fn` over the (B * n, C, H, W) frames of each run that `read` gives of an input of `shape`, back to NCDHW."""
    b, c, t = shape[:3]
    step = frame_step(t, elements)
    out = None
    for t0 in range(0, t, step):
        frames = read(t0, min(t0 + step, t))
        n = frames.shape[2]
        y = fn(frames.transpose(1, 2).reshape(b * n, c, *frames.shape[3:]))
        y = y.reshape(b, n, *y.shape[1:]).transpose(1, 2)
        if step >= t:
            return y
        if out is None:
            out = torch.empty((b, out_channels, t, *y.shape[3:]), dtype=y.dtype, device=y.device)
        out[:, :, t0:t0 + n] = y
    return out


class CogDownsample3D(nn.Module):
    """`vae.py:150-168`: frame 0 kept and frames 1.. averaged in pairs (`compress_time`), then per frame a
    right/bottom pad of one and a stride-2 3x3 conv (a torch Conv2d's weights at `.conv`)."""

    def __init__(self, dim: int, compress_time: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.compress_time = compress_time
        self.conv = ConvWeights(dim, dim, (3, 3), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        if self.compress_time and t > 1:
            if (t - 1) % 2:
                raise ValueError(f"the time-compressing downsampler takes 1 + 2k frames, got {t}")
            t = 1 + (t - 1) // 2

            def read(a: int, e: int) -> torch.Tensor:
                first = x[:, :, :1] if a == 0 else x[:, :, :0]
                lo, hi = max(a, 1), e
                rest = x[:, :, 2 * lo - 1:2 * hi - 1].float().reshape(b, c, hi - lo, 2, h, w).mean(3).to(x.dtype)
                return torch.cat([first, rest], dim=2)
        else:
            def read(a: int, e: int) -> torch.Tensor:
                return x[:, :, a:e]

        def conv(frames: torch.Tensor) -> torch.Tensor:
            return F.conv2d(F.pad(frames.to(self.conv.weight.dtype), (0, 1, 0, 1)), self.conv.weight,
                            self.conv.bias, stride=2)

        return _per_frame_2d(read, (b, c, t, h, w), conv, b * c * t * h * w, c)


class CogUpsample3D(nn.Module):
    """`vae.py:171-190`: nearest x2 in space, frames 1.. doubled in time (`compress_time`; frame 0 single),
    then a 3x3 SAME conv per frame."""

    def __init__(self, dim: int, compress_time: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.compress_time = compress_time
        self.conv = ConvWeights(dim, dim, (3, 3), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        read, shape = upsampled_reader(x, self.compress_time)

        def conv(frames: torch.Tensor) -> torch.Tensor:
            return F.conv2d(frames.to(self.conv.weight.dtype), self.conv.weight, self.conv.bias, padding=1)

        return _per_frame_2d(read, shape, conv, math.prod(shape), self.conv.weight.shape[0])


class CogDownBlock3D(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int, groups: int, add_downsample: bool,
                 compress_time: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([CogResnetBlock3D(in_dim if j == 0 else out_dim, out_dim, groups, None, dtype)
                                      for j in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([CogDownsample3D(out_dim, compress_time, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class CogUpBlock3D(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int, groups: int, spatial_norm_dim: int,
                 add_upsample: bool, compress_time: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([CogResnetBlock3D(in_dim if j == 0 else out_dim, out_dim, groups,
                                                       spatial_norm_dim, dtype) for j in range(num_layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([CogUpsample3D(out_dim, compress_time, dtype)])

    def forward(self, x: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x, zq)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _MidBlock(nn.Module):
    """Two resnets, no attention (diffusers' `mid_block.resnets`)."""

    def __init__(self, dim: int, groups: int, spatial_norm_dim: Optional[int], dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([CogResnetBlock3D(dim, dim, groups, spatial_norm_dim, dtype) for _ in range(2)])

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor] = None) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x, zq)
        return x


class CogVideoXEncoder3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        g, boc = cfg.norm_num_groups, cfg.block_out_channels
        temporal_levels = int(math.log2(cfg.temporal_compression_ratio))
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], dtype=dtype)
        self.down_blocks = nn.ModuleList([
            CogDownBlock3D(boc[max(i - 1, 0)], out_ch, cfg.layers_per_block, g, add_downsample=i < len(boc) - 1,
                           compress_time=i < temporal_levels, dtype=dtype) for i, out_ch in enumerate(boc)])
        self.mid_block = _MidBlock(boc[-1], g, None, dtype)
        self.norm_out = ClipGroupNorm(boc[-1], g)
        self.conv_out = CausalConv3d(boc[-1], 2 * cfg.latent_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.norm_out(self.mid_block(x), post=silu_post))


class CogVideoXDecoder3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        g, channels = cfg.norm_num_groups, tuple(reversed(cfg.block_out_channels))
        temporal_levels = int(math.log2(cfg.temporal_compression_ratio))
        zc = cfg.latent_channels
        self.conv_in = CausalConv3d(zc, channels[0], dtype=dtype)
        self.mid_block = _MidBlock(channels[0], g, zc, dtype)
        self.up_blocks = nn.ModuleList([
            CogUpBlock3D(channels[max(i - 1, 0)], out_ch, cfg.layers_per_block + 1, g, zc,
                         add_upsample=i < len(channels) - 1, compress_time=i < temporal_levels, dtype=dtype)
            for i, out_ch in enumerate(channels)])
        self.norm_out = CogSpatialNorm3D(channels[-1], zc, g, dtype)
        self.conv_out = CausalConv3d(channels[-1], cfg.out_channels, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z), z)
        for block in self.up_blocks:
            x = block(x, z)
        return self.conv_out(self.norm_out(x, z, silu=True))


class AutoencoderKLCogVideoX(nn.Module):
    """Public boundary NCDHW (B, C, T, H, W), T = 1 + 4k frames; the moments
    and the decoded video are fp32 (`vae.py:293-320`)."""

    def __init__(self, config: CogVideoXVAEConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = CogVideoXEncoder3D(config, dtype)
        self.decoder = CogVideoXDecoder3D(config, dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) in [-1, 1] -> moments (B, 2 latent, 1 + (T - 1) / 4, H / 8, W / 8)."""
        return self.encoder(x.to(self.dtype)).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z.to(self.dtype)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode(x).chunk(2, dim=1)
        return self.decode(mean)
