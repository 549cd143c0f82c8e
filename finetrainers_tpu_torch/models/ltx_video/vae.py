"""LTX-Video's causal 3D VAE, `AutoencoderKLLTXVideo` of the 0.9.0 config
family (port of `finetrainers_tpu/models/ltx_video/vae.py:41-366`).

  - A causal conv wraps its nn.Conv3d as `.conv` (its keys carry the extra
    level); time is padded by REPLICATE, in front only (kt - 1 copies of the
    first frame) where causal, the encoder, and on both sides in the
    decoder; space by SAME zeros.
  - The RMS norms have no parameters.
  - The encoder patchifies (p = 4, pt = 1, channel order (c, pt, p, q)),
    downsamples by stride-(2, 2, 2) convs, and its conv_out emits
    latent_channels + 1 channels whose last is repeated into the whole
    log-variance half (the shared-logvar channel).
  - The decoder: conv_in, the mid block, up blocks (a conv_in resnet where
    the width changes, the upsampler's conv to 8 C and depth-to-space by
    (2, 2, 2) with its leading frame trimmed, resnets), the norm, conv_out,
    unpatchify.
  - 1 + 8k frames -> 1 + k latent frames; 32x in space.

Layout is NCDHW throughout; parameter names are those JAX's `ltx_vae_key_map`
gives its exporter, conv weights torch's (out, in, kt, kh, kw).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LTXVAEConfig:
    """`finetrainers_tpu/models/ltx_video/vae.py:41-92`'s config; the scaling
    factor is the handle's, read from config.json by `_load_video_vae`."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decoder_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: Tuple[int, ...] = (4, 3, 3, 3, 4)
    decoder_layers_per_block: Tuple[int, ...] = (4, 3, 3, 3, 4)
    spatio_temporal_scaling: Tuple[bool, ...] = (True, True, True, False)
    decoder_spatio_temporal_scaling: Tuple[bool, ...] = (True, True, True, False)
    patch_size: int = 4
    patch_size_t: int = 1
    resnet_norm_eps: float = 1e-6
    encoder_causal: bool = True
    decoder_causal: bool = False

    @classmethod
    def from_hf(cls, cfg: dict) -> "LTXVAEConfig":
        return cls(
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg.get("latent_channels", 128),
            block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
            decoder_block_out_channels=tuple(
                cfg.get("decoder_block_out_channels", cfg.get("block_out_channels", (128, 256, 512, 512)))
            ),
            layers_per_block=tuple(cfg.get("layers_per_block", (4, 3, 3, 3, 4))),
            decoder_layers_per_block=tuple(
                cfg.get("decoder_layers_per_block", cfg.get("layers_per_block", (4, 3, 3, 3, 4)))
            ),
            spatio_temporal_scaling=tuple(cfg.get("spatio_temporal_scaling", (True, True, True, False))),
            decoder_spatio_temporal_scaling=tuple(
                cfg.get("decoder_spatio_temporal_scaling",
                        cfg.get("spatio_temporal_scaling", (True, True, True, False)))
            ),
            patch_size=cfg.get("patch_size", 4),
            patch_size_t=cfg.get("patch_size_t", 1),
            resnet_norm_eps=cfg.get("resnet_norm_eps", 1e-6),
            encoder_causal=cfg.get("encoder_causal", True),
            decoder_causal=cfg.get("decoder_causal", False),
        )

    @property
    def spatial_compression_ratio(self) -> int:
        return self.patch_size * 2 ** sum(self.spatio_temporal_scaling)

    @property
    def temporal_compression_ratio(self) -> int:
        return self.patch_size_t * 2 ** sum(self.spatio_temporal_scaling)


def _rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """diffusers' RMSNorm(elementwise_affine=False) over channels, in fp32."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=1, keepdim=True) + eps)).to(x.dtype)


class _Conv3d(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, kernel_size, stride, dtype: torch.dtype) -> None:
        super().__init__()
        self.stride = tuple(stride)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, *kernel_size, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight[0].numel() ** -0.5, generator=generator)
            self.bias.zero_()


class LTXCausalConv3d(nn.Module):
    """diffusers' `LTXVideoCausalConv3d` (`vae.py:106-132`)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size=(3, 3, 3), stride=(1, 1, 1), is_causal: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.kernel_size, self.is_causal = tuple(kernel_size), is_causal
        self.conv = _Conv3d(in_dim, out_dim, self.kernel_size, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel_size
        x = x.to(self.conv.weight.dtype)
        if kt > 1:
            front = (kt - 1) if self.is_causal else (kt - 1) // 2
            back = 0 if self.is_causal else kt // 2
            parts = [x[:, :, :1].expand(-1, -1, front, -1, -1), x]
            if back:
                parts.append(x[:, :, -1:].expand(-1, -1, back, -1, -1))
            x = torch.cat(parts, dim=2)
        x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        return F.conv3d(x, self.conv.weight, self.conv.bias, stride=self.conv.stride)


class LTXResnetBlock3d(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, eps: float, is_causal: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.eps = eps
        self.conv1 = LTXCausalConv3d(in_dim, out_dim, is_causal=is_causal, dtype=dtype)
        self.conv2 = LTXCausalConv3d(out_dim, out_dim, is_causal=is_causal, dtype=dtype)
        if in_dim != out_dim:
            self.conv_shortcut = LTXCausalConv3d(in_dim, out_dim, (1, 1, 1), is_causal=is_causal, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(_rms_norm(x, self.eps)))
        h = self.conv2(F.silu(_rms_norm(h, self.eps)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x.to(h.dtype) + h


class LTXDownBlock3D(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int, scale: bool, eps: float, is_causal: bool,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([LTXResnetBlock3d(in_dim, in_dim, eps, is_causal, dtype)
                                      for _ in range(num_layers)])
        if scale:
            self.downsamplers = nn.ModuleList([LTXCausalConv3d(in_dim, in_dim, stride=(2, 2, 2), is_causal=is_causal,
                                                               dtype=dtype)])
        if in_dim != out_dim:
            self.conv_out = LTXResnetBlock3d(in_dim, out_dim, eps, is_causal, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return self.conv_out(x) if hasattr(self, "conv_out") else x


class LTXMidBlock3d(nn.Module):
    def __init__(self, dim: int, num_layers: int, eps: float, is_causal: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([LTXResnetBlock3d(dim, dim, eps, is_causal, dtype) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x


class LTXUpsampler3d(nn.Module):
    """A conv to 8 C, depth-to-space by (2, 2, 2) with channel order (c, p1,
    p2, p3), the leading frame trimmed (`vae.py:214-232`)."""

    def __init__(self, dim: int, is_causal: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.dim = dim
        self.conv = LTXCausalConv3d(dim, dim * 8, is_causal=is_causal, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, t, h, w = x.shape
        y = self.conv(x).reshape(b, self.dim, 2, 2, 2, t, h, w)
        y = y.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, self.dim, 2 * t, 2 * h, 2 * w)
        return y[:, :, 1:]


class LTXUpBlock3d(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int, scale: bool, eps: float, is_causal: bool,
                 dtype: torch.dtype) -> None:
        super().__init__()
        if in_dim != out_dim:
            self.conv_in = LTXResnetBlock3d(in_dim, out_dim, eps, is_causal, dtype)
        if scale:
            self.upsamplers = nn.ModuleList([LTXUpsampler3d(out_dim, is_causal, dtype)])
        self.resnets = nn.ModuleList([LTXResnetBlock3d(out_dim, out_dim, eps, is_causal, dtype)
                                      for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv_in"):
            x = self.conv_in(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        for resnet in self.resnets:
            x = resnet(x)
        return x


def _patchify(x: torch.Tensor, p: int, pt: int) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, C pt p p, T / pt, H / p, W / p), channel order (c, pt, p, q)."""
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // pt, pt, h // p, p, w // p, p)
    return x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, c * pt * p * p, t // pt, h // p, w // p)


def _unpatchify(x: torch.Tensor, p: int, pt: int, out_channels: int) -> torch.Tensor:
    b, _, t, h, w = x.shape
    x = x.reshape(b, out_channels, pt, p, p, t, h, w)
    return x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, out_channels, t * pt, h * p, w * p)


class LTXEncoder3d(nn.Module):
    def __init__(self, cfg: LTXVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        causal, eps, chans = cfg.encoder_causal, cfg.resnet_norm_eps, cfg.block_out_channels
        in_patch = cfg.in_channels * cfg.patch_size_t * cfg.patch_size ** 2
        self.conv_in = LTXCausalConv3d(in_patch, chans[0], is_causal=causal, dtype=dtype)
        blocks, out_ch = [], chans[0]
        for i in range(len(chans)):
            in_ch, out_ch = out_ch, chans[i + 1] if i + 1 < len(chans) else chans[-1]
            blocks.append(LTXDownBlock3D(in_ch, out_ch, cfg.layers_per_block[i], cfg.spatio_temporal_scaling[i],
                                         eps, causal, dtype))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = LTXMidBlock3d(out_ch, cfg.layers_per_block[-1], eps, causal, dtype)
        self.conv_out = LTXCausalConv3d(out_ch, cfg.latent_channels + 1, is_causal=causal, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.conv_in(_patchify(x, cfg.patch_size, cfg.patch_size_t))
        for block in self.down_blocks:
            x = block(x)
        x = self.conv_out(F.silu(_rms_norm(self.mid_block(x), cfg.resnet_norm_eps)))
        # The shared log-variance: the last of latent + 1 channels repeated latent - 1 more times.
        return torch.cat([x, x[:, -1:].expand(-1, cfg.latent_channels - 1, -1, -1, -1)], dim=1)


class LTXDecoder3d(nn.Module):
    def __init__(self, cfg: LTXVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        causal, eps = cfg.decoder_causal, cfg.resnet_norm_eps
        chans = tuple(reversed(cfg.decoder_block_out_channels))
        scaling = tuple(reversed(cfg.decoder_spatio_temporal_scaling))
        layers = tuple(reversed(cfg.decoder_layers_per_block))
        self.conv_in = LTXCausalConv3d(cfg.latent_channels, chans[0], is_causal=causal, dtype=dtype)
        self.mid_block = LTXMidBlock3d(chans[0], layers[0], eps, causal, dtype)
        blocks, out_ch = [], chans[0]
        for i in range(len(chans)):
            in_ch, out_ch = out_ch, chans[i + 1] if i + 1 < len(chans) else chans[-1]
            blocks.append(LTXUpBlock3d(in_ch, out_ch, layers[i + 1], scaling[i], eps, causal, dtype))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_out = LTXCausalConv3d(out_ch, cfg.out_channels * cfg.patch_size_t * cfg.patch_size ** 2,
                                        is_causal=causal, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        x = self.conv_out(F.silu(_rms_norm(x, cfg.resnet_norm_eps)))
        return _unpatchify(x, cfg.patch_size, cfg.patch_size_t, cfg.out_channels)


class AutoencoderKLLTXVideo(nn.Module):
    """Public boundary NCDHW (B, C, T, H, W), T = 1 + 8k frames; the moments
    and the decoded video are fp32 (`vae.py:315-339`)."""

    def __init__(self, config: LTXVAEConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = LTXEncoder3d(config, dtype)
        self.decoder = LTXDecoder3d(config, dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 1 + 8k, H, W) -> moments (B, 2 * 128, 1 + k, H / 32, W / 32)."""
        return self.encoder(x.to(self.dtype)).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z.to(self.dtype)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode(x).chunk(2, dim=1)
        return self.decode(mean)
