"""Wan 2.1's causal 3D VAE, `AutoencoderKLWan` (port of
`finetrainers_tpu/models/wan/vae.py:43-327`).

JAX folds diffusers' chunked causal forward (frame 0 alone, then 4-frame
chunks with a feature cache) into one pass, and the port computes that
single-shot function:
  - a causal conv pads kt - 1 zero frames in front (the first chunk's zeros;
    later chunks' cached frames make it one global causal conv), SAME zeros
    in space;
  - `downsample3d` convolves in space (ZeroPad2d (0, 1, 0, 1), stride 2), then
    keeps frame 0 untouched beside a valid stride-2 time conv over all
    frames: 1 + 4k frames -> 1 + k latent frames;
  - `upsample3d` keeps frame 0 out of its 2C-channel causal time conv, whose
    two halves interleave into 2 (T - 1) frames after it (1 + k -> 1 + 2k),
    then upsamples nearest 2x in space. This alignment of the decoder's first
    chunk is JAX's own best effort (`vae.py:22-24`), not checked against
    diffusers' decode (ROADMAP.md section 3, finding 25);
  - `WanRMS_norm` is x / ||x||_2 over channels * sqrt(C) * gamma in fp32, the
    gammas at their torch shapes (C, 1, 1, 1) and (C, 1, 1);
  - the mid block's attention is per frame, one head over H * W, in fp32.

Layout is NCDHW throughout (JAX runs NDHWC inside, NCDHW at its boundary).
Parameter names are those JAX's `wan_vae_key_map` gives its exporter
(`encoder.down_blocks.{i}` and `decoder.up_blocks.{i}` flat, a causal conv's
weight directly on it, the spatial resample conv at `resample.1`), so such a
`vae/` directory loads by name; conv weights are torch's (out, in, kt, kh, kw).

Large activations: past `autoencoders.SPLIT_ELEMENTS` a causal conv runs in
runs of output frames (each from its inputs and kt - 1 frames before them),
and the norms and the per-frame 2D ops in runs of frames; all exact, since
each output frame of a causal conv reads only those input frames.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..autoencoders import _pieces


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    """`finetrainers_tpu/models/wan/vae.py:43-75`'s config; the latent
    statistics are the handle's, read from config.json by `_load_video_vae`."""

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)

    @classmethod
    def from_hf(cls, cfg: dict) -> "WanVAEConfig":
        return cls(
            base_dim=cfg.get("base_dim", 96),
            z_dim=cfg.get("z_dim", 16),
            dim_mult=tuple(cfg.get("dim_mult", (1, 2, 4, 4))),
            num_res_blocks=cfg.get("num_res_blocks", 2),
            attn_scales=tuple(cfg.get("attn_scales", ())),
            temperal_downsample=tuple(cfg.get("temperal_downsample", (False, True, True))),
        )

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def temporal_compression_ratio(self) -> int:
        return 2 ** sum(self.temperal_downsample)


def _conv_init(weight: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        weight.normal_(0.0, weight[0].numel() ** -0.5, generator=generator)
        bias.zero_()


def _by_frames(x: torch.Tensor, fn, frames_per_run: Optional[int] = None) -> torch.Tensor:
    """fn over runs of frames of NCDHW `x` (one run where `x` is small), joined on the time axis."""
    step = frames_per_run or _pieces(x.shape[2], x.numel())
    if step >= x.shape[2]:
        return fn(x)
    return torch.cat([fn(x[:, :, t0:t0 + step]) for t0 in range(0, x.shape[2], step)], dim=2)


class WanCausalConv3d(nn.Module):
    """diffusers' `WanCausalConv3d` (an nn.Conv3d, weights on the module):
    kt - 1 zero frames in front (none with `temporal_pad` False), SAME zeros in
    space (`vae.py:97-119`)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size=(3, 3, 3), stride=(1, 1, 1),
                 temporal_pad: bool = True, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.kernel_size, self.stride, self.temporal_pad = tuple(kernel_size), tuple(stride), temporal_pad
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, *self.kernel_size, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _conv_init(self.weight, self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel_size
        st = self.stride[0]
        x = x.to(self.weight.dtype)
        pad = kt - 1 if self.temporal_pad else 0
        t_out = (x.shape[2] + pad - kt) // st + 1

        def frames(t0: int, t1: int) -> torch.Tensor:  # output frames [t0, t1) from their input frames
            lo, hi = t0 * st - pad, (t1 - 1) * st + kt - pad
            rows = x[:, :, max(lo, 0):hi]
            if lo < 0:
                rows = F.pad(rows, (0, 0, 0, 0, -lo, 0))
            return F.conv3d(rows, self.weight, self.bias, stride=self.stride, padding=(0, kh // 2, kw // 2))

        elements = x.numel() * max(self.weight.shape[0] / max(x.shape[1], 1), 1.0)
        step = _pieces(t_out, int(elements))
        if step >= t_out:
            return frames(0, t_out)
        return torch.cat([frames(t0, min(t0 + step, t_out)) for t0 in range(0, t_out, step)], dim=2)


class _Conv2d(nn.Module):
    """A per-frame 2D conv (the resample conv, the attention's 1x1 convs)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, kernel, kernel, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _conv_init(self.weight, self.bias, generator)

    def forward(self, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
        return F.conv2d(x.to(self.weight.dtype), self.weight, self.bias, stride=stride, padding=padding)


def _frames_2d(x: torch.Tensor, fn) -> torch.Tensor:
    """fn over (B*T, C, H, W) images of NCDHW `x`, back to NCDHW."""
    b, c, t, h, w = x.shape
    y = fn(x.transpose(1, 2).reshape(b * t, c, h, w))
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


class WanRMSNorm(nn.Module):
    """`WanRMS_norm`: F.normalize over channels * sqrt(C) * gamma, in fp32;
    gamma (C, 1, 1, 1) for video features, (C, 1, 1) per frame (`vae.py:78-94`)."""

    def __init__(self, dim: int, gamma_ndim: int = 4) -> None:
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.empty((dim,) + (1,) * (gamma_ndim - 1), dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma = self.gamma.reshape(1, -1, 1, 1, 1)

        def norm(xs: torch.Tensor) -> torch.Tensor:
            xf = xs.float()
            n = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
            return (xf / torch.clamp(n, min=1e-12) * (self.dim ** 0.5) * gamma).to(xs.dtype)

        return _by_frames(x, norm, _pieces(x.shape[2], 2 * x.numel()))


class WanResidualBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.norm1 = WanRMSNorm(in_dim)
        self.conv1 = WanCausalConv3d(in_dim, out_dim, dtype=dtype)
        self.norm2 = WanRMSNorm(out_dim)
        self.conv2 = WanCausalConv3d(out_dim, out_dim, dtype=dtype)
        if in_dim != out_dim:
            self.conv_shortcut = WanCausalConv3d(in_dim, out_dim, (1, 1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        y = self.conv1(F.silu(self.norm1(x)))
        y = self.conv2(F.silu(self.norm2(y)))
        return h + y


class WanAttentionBlock(nn.Module):
    """Per-frame single-head self-attention over H * W (`vae.py:137-162`):
    norm, a 1x1 `to_qkv`, fp32 scores and softmax, a 1x1 `proj`, residual."""

    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dim = dim
        self.norm = WanRMSNorm(dim, gamma_ndim=3)
        self.to_qkv = _Conv2d(dim, 3 * dim, 1, dtype)
        self.proj = _Conv2d(dim, dim, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.dim

        def attend(frames: torch.Tensor) -> torch.Tensor:
            n, _, hh, ww = frames.shape
            qkv = self.to_qkv(frames).reshape(n, 3 * c, hh * ww).transpose(1, 2)
            q, k, v = qkv.float().chunk(3, dim=-1)
            attn = torch.softmax((q * c ** -0.5) @ k.transpose(1, 2), dim=-1)
            y = (attn @ v).to(frames.dtype).transpose(1, 2).reshape(n, c, hh, ww)
            return self.proj(y)

        y = _by_frames(self.norm(x), lambda xs: _frames_2d(xs, attend), frames_per_run=1)
        return x + y.to(x.dtype)


class WanResample(nn.Module):
    """downsample2d / downsample3d / upsample2d / upsample3d (`vae.py:165-227`);
    the spatial conv sits at index 1 of a torch Sequential (`resample.1`)."""

    def __init__(self, dim: int, mode: str, dtype: torch.dtype) -> None:
        super().__init__()
        self.dim, self.mode = dim, mode
        up = mode.startswith("upsample")
        self.resample = nn.ModuleList([nn.Identity(), _Conv2d(dim, dim // 2 if up else dim, 3, dtype)])
        if mode == "upsample3d":
            self.time_conv = WanCausalConv3d(dim, dim * 2, (3, 1, 1), dtype=dtype)
        elif mode == "downsample3d":
            self.time_conv = WanCausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), temporal_pad=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.resample[1]
        if self.mode == "upsample3d" and x.shape[2] > 1:
            # frame 0 passes un-doubled; frames 1.. form their own causal sequence whose 2C output channels
            # are the two frames each becomes.
            b, c, t, h, w = x.shape
            y = self.time_conv(x[:, :, 1:]).reshape(b, 2, c, t - 1, h, w)
            y = y.permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * (t - 1), h, w)
            x = torch.cat([x[:, :, :1].to(y.dtype), y], dim=2)
        if self.mode.startswith("upsample"):
            up = lambda f: conv(F.interpolate(f, scale_factor=2.0, mode="nearest"), padding=1)  # noqa: E731
            return _by_frames(x, lambda xs: _frames_2d(xs, up), _pieces(x.shape[2], 8 * x.numel()))
        down = lambda f: conv(F.pad(f, (0, 1, 0, 1)), stride=2)  # noqa: E731
        x = _by_frames(x, lambda xs: _frames_2d(xs, down))
        if self.mode == "downsample3d" and x.shape[2] >= 3:
            x = torch.cat([x[:, :, :1], self.time_conv(x)], dim=2)
        elif self.mode == "downsample3d":
            x = x[:, :, :1]  # a single frame (or two): the cache-init branch only
        return x


class WanMidBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, num_layers: int = 1) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(dim, dim, dtype) for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([WanAttentionBlock(dim, dtype) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x))
        return x


class WanEncoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        dims = [cfg.base_dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv_in = WanCausalConv3d(3, dims[0], dtype=dtype)
        blocks, scale = [], 1.0
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            cur = in_dim
            for _ in range(cfg.num_res_blocks):
                blocks.append(WanResidualBlock(cur, out_dim, dtype))
                if scale in cfg.attn_scales:
                    blocks.append(WanAttentionBlock(out_dim, dtype))
                cur = out_dim
            if i != len(cfg.dim_mult) - 1:
                blocks.append(WanResample(out_dim, "downsample3d" if cfg.temperal_downsample[i] else "downsample2d",
                                          dtype))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = WanMidBlock(dims[-1], dtype)
        self.norm_out = WanRMSNorm(dims[-1])
        self.conv_out = WanCausalConv3d(dims[-1], 2 * cfg.z_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class WanDecoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        mults = (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))
        dims = [cfg.base_dim * u for u in mults]
        temperal_upsample = tuple(reversed(cfg.temperal_downsample))
        self.conv_in = WanCausalConv3d(cfg.z_dim, dims[0], dtype=dtype)
        self.mid_block = WanMidBlock(dims[0], dtype)
        blocks = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            cur = in_dim // 2 if i > 0 else in_dim  # the upsampler halved the channels
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(WanResidualBlock(cur, out_dim, dtype))
                cur = out_dim
            if i != len(cfg.dim_mult) - 1:
                blocks.append(WanResample(out_dim, "upsample3d" if temperal_upsample[i] else "upsample2d", dtype))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = WanRMSNorm(dims[-1])
        self.conv_out = WanCausalConv3d(dims[-1], 3, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class AutoencoderKLWan(nn.Module):
    """Public boundary NCDHW (B, C, T, H, W), T = 1 + 4k frames; the moments
    and the decoded video are fp32 (`vae.py:270-293`)."""

    def __init__(self, config: WanVAEConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = WanEncoder3d(config, dtype)
        self.decoder = WanDecoder3d(config, dtype)
        self.quant_conv = WanCausalConv3d(2 * config.z_dim, 2 * config.z_dim, (1, 1, 1), dtype=dtype)
        self.post_quant_conv = WanCausalConv3d(config.z_dim, config.z_dim, (1, 1, 1), dtype=dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) in [-1, 1] -> moments (B, 2 z, 1 + (T - 1) / 4, H / 8, W / 8)."""
        return self.quant_conv(self.encoder(x.to(self.dtype))).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype))).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode(x).chunk(2, dim=1)
        return self.decode(mean)
