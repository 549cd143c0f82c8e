"""The 2D AutoencoderKL, the image VAE of SD, Flux and CogView4 (port of
`finetrainers_tpu/models/autoencoder_kl.py`).

Module names are diffusers' `AutoencoderKL`'s (`encoder.down_blocks.{i}.
resnets.{j}.conv1`, `encoder.mid_block.attentions.0.to_out.0`,
`decoder.up_blocks.{i}.upsamplers.0.conv`, `quant_conv`, ...), so a
checkpoint's state dict loads by name (`weight_utils.load_named_weights`);
conv weights are torch's (out, in, kh, kw) as the checkpoint stores them
(JAX transposes them to HWIO, `load_autoencoder_kl_params`). NCHW throughout;
convs and linears in the VAE's dtype, GroupNorm statistics and the mid
block's single-head attention in fp32, as in JAX. Encode returns the
moments (B, 2C, H/r, W/r) and decode the image, both fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LoRADense


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    """Copied from `finetrainers_tpu/models/autoencoder_kl.py:30-60`; the
    defaults are SD's widths, `from_hf` reads a diffusers config.json (the
    latent statistics too)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True
    scaling_factor: float = 0.18215
    shift_factor: Optional[float] = None

    @classmethod
    def from_hf(cls, cfg: dict) -> "AutoencoderKLConfig":
        return cls(
            in_channels=cfg.get("in_channels", 3), out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg.get("latent_channels", 4),
            block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=cfg.get("layers_per_block", 2), norm_num_groups=cfg.get("norm_num_groups", 32),
            use_quant_conv=cfg.get("use_quant_conv", True), use_post_quant_conv=cfg.get("use_post_quant_conv", True),
            scaling_factor=cfg.get("scaling_factor", 0.18215), shift_factor=cfg.get("shift_factor"),
        )

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class Conv2d(nn.Module):
    """A 2D convolution (flax `nn.Conv`): `padding` 1 is SAME for the 3x3
    kernels, 0 the 1x1 kernels' and the downsampler's VALID."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_channels, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight[0].numel()**-0.5, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.weight.dtype), self.weight, self.bias, stride=self.stride, padding=self.padding)


class GroupNorm2d(nn.Module):
    """GroupNorm with fp32 statistics and fp32 affine parameters (eps 1e-6),
    the output in the input's dtype."""

    def __init__(self, channels: int, groups: int) -> None:
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(channels, dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, 1e-6).to(x.dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.norm1 = GroupNorm2d(in_channels, groups)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm2d(out_channels, groups)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock2D(nn.Module):
    """The mid block's attention: one head over all channels, group norm, a
    residual (`AttentionBlock2D`, autoencoder_kl.py:85-110). Its softmax is
    plain fp32 math, as the JAX package's (an XLA einsum, not a Pallas kernel)."""

    def __init__(self, channels: int, groups: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.group_norm = GroupNorm2d(channels, groups)
        self.to_q, self.to_k, self.to_v = (LoRADense(channels, channels, dtype=dtype) for _ in range(3))
        self.to_out = nn.ModuleList([LoRADense(channels, channels, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        scores = (q.float() * c**-0.5) @ k.float().transpose(1, 2)
        y = (torch.softmax(scores, dim=-1) @ v.float()).to(x.dtype)
        return x + self.to_out[0](y).transpose(1, 2).reshape(b, c, h, w)


class MidBlock2D(nn.Module):
    def __init__(self, channels: int, groups: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups, dtype) for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock2D(channels, groups, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Resample(nn.Module):
    """diffusers' Downsample2D (pad right and bottom by one, a stride-2 VALID
    3x3 conv) or Upsample2D (nearest x2, then a SAME 3x3 conv)."""

    def __init__(self, channels: int, down: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.down = down
        self.conv = Conv2d(channels, channels, 3, stride=2 if down else 1, padding=0 if down else 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1)) if self.down else F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x)


class _Block(nn.Module):
    """DownEncoderBlock2D / UpDecoderBlock2D: resnets, then the resampler."""

    def __init__(self, in_channels: int, channels: int, layers: int, groups: int, resample: Optional[str],
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(in_channels if j == 0 else channels, channels, groups, dtype)
                                      for j in range(layers)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Resample(channels, True, dtype)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_Resample(channels, False, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for resample in (getattr(self, "downsamplers", ()) or getattr(self, "upsamplers", ())):
            x = resample(x)
        return x


class Encoder2D(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig, dtype: torch.dtype) -> None:
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1, dtype=dtype)
        self.down_blocks = nn.ModuleList([
            _Block(ch[max(i - 1, 0)], c, cfg.layers_per_block, g, "down" if i < len(ch) - 1 else None, dtype)
            for i, c in enumerate(ch)])
        self.mid_block = MidBlock2D(ch[-1], g, dtype)
        self.conv_norm_out = GroupNorm2d(ch[-1], g)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class Decoder2D(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig, dtype: torch.dtype) -> None:
        super().__init__()
        ch, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, ch[0], 3, padding=1, dtype=dtype)
        self.mid_block = MidBlock2D(ch[0], g, dtype)
        self.up_blocks = nn.ModuleList([
            _Block(ch[max(i - 1, 0)], c, cfg.layers_per_block + 1, g, "up" if i < len(ch) - 1 else None, dtype)
            for i, c in enumerate(ch)])
        self.conv_norm_out = GroupNorm2d(ch[-1], g)
        self.conv_out = Conv2d(ch[-1], cfg.out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """diffusers' AutoencoderKL (`AutoencoderKL`, autoencoder_kl.py:222-253)."""

    def __init__(self, config: AutoencoderKLConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = Encoder2D(config, dtype)
        self.decoder = Decoder2D(config, dtype)
        if config.use_quant_conv:
            self.quant_conv = Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1, dtype=dtype)
        if config.use_post_quant_conv:
            self.post_quant_conv = Conv2d(config.latent_channels, config.latent_channels, 1, dtype=dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) in [-1, 1] -> fp32 moments (B, 2 latent, H/r, W/r)."""
        moments = self.encoder(x.to(self.dtype))
        if self.config.use_quant_conv:
            moments = self.quant_conv(moments)
        return moments.float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent, H', W') -> the fp32 image (B, C, H' r, W' r)."""
        h = z.to(self.dtype)
        if self.config.use_post_quant_conv:
            h = self.post_quant_conv(h)
        return self.decoder(h).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode(x).chunk(2, dim=1)
        return self.decode(mean)
