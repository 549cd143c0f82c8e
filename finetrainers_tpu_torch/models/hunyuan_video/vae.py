"""HunyuanVideo's causal 3D VAE, `AutoencoderKLHunyuanVideo` (port of
`finetrainers_tpu/models/hunyuan_video/vae.py:41-313`).

  - Causal convs (`causal_vae.CausalConv3d`: weights at `.conv`, kt - 1
    copies of frame 0 in front, SAME zeros in space); the shortcut and the
    down- and upsamplers' convs are causal convs too.
  - GroupNorms take their fp32 statistics over the whole clip (the VAE is
    causal through its convs only).
  - The encoder downsamples with stride-2 causal convs: 8x in space over the
    first three blocks, 4x in time over blocks 1-2 (1 + 4k -> 1 + k frames).
  - The decoder upsamples frame 0 in space only and frames 1.. in time and
    space (1 + k -> 1 + 2k a temporal stage), nearest x2, then a causal 3x3x3
    conv.
  - The mid blocks hold one single-head attention over all T * H * W tokens at
    the block's width, its scores and softmax in fp32 (`vae.py:113-134`). At
    modal_labs_dissolve's 49x480x768 that is 74,880 tokens, whose 5.6e9 fp32
    scores would take 22.4 GB at once: the port takes them in chunks of query
    rows (`ATTENTION_SCORE_ELEMENTS`), each row's softmax over all keys, so the
    result is the single pass's. Plain torch matmuls, as JAX's are plain XLA
    dots (no K1 call: head dim 512, fp32).
  - `quant_conv` and `post_quant_conv` are plain 1x1x1 convs.

Layout is NCDHW throughout (JAX runs NDHWC inside, NCDHW at its boundary).
Parameter names are those `hunyuan_vae_key_map` gives JAX's exporter
(`encoder.down_blocks.{i}.downsamplers.0.conv.conv`,
`encoder.mid_block.attentions.0.to_out.0`, ...), conv weights torch's (out,
in, kt, kh, kw), linear weights (out, in). Past `autoencoders.SPLIT_ELEMENTS`
every conv and norm runs in runs of frames (`causal_vae`), an upsampler
upsampling only the frames its conv's run reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..causal_vae import CausalConv3d, ClipGroupNorm, ConvWeights, silu_post, upsampled_reader
from ..layers import LoRADense

# The mid block's attention computes at most this many fp32 scores at once (a chunk of query rows against every
# key); the tests lower it to force several chunks.
ATTENTION_SCORE_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class HunyuanVAEConfig:
    """Copied from `finetrainers_tpu/models/hunyuan_video/vae.py:40-66`."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.476986
    spatial_compression_ratio: int = 8
    temporal_compression_ratio: int = 4
    mid_block_add_attention: bool = True

    @classmethod
    def from_hf(cls, cfg: dict) -> "HunyuanVAEConfig":
        return cls(
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg.get("latent_channels", 16),
            block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=cfg.get("layers_per_block", 2),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            scaling_factor=cfg.get("scaling_factor", 0.476986),
            spatial_compression_ratio=cfg.get("spatial_compression_ratio", 8),
            temporal_compression_ratio=cfg.get("temporal_compression_ratio", 4),
            mid_block_add_attention=cfg.get("mid_block_add_attention", True),
        )


class HunyuanResnetBlock3D(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, groups: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.norm1 = ClipGroupNorm(in_dim, groups)
        self.conv1 = CausalConv3d(in_dim, out_dim, dtype=dtype)
        self.norm2 = ClipGroupNorm(out_dim, groups)
        self.conv2 = CausalConv3d(out_dim, out_dim, dtype=dtype)
        if in_dim != out_dim:
            self.conv_shortcut = CausalConv3d(in_dim, out_dim, (1, 1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, post=silu_post))
        h = self.conv2(self.norm2(h, post=silu_post))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return h.add_(x)


class HunyuanAttentionBlock(nn.Module):
    """SD-style single-head attention over all T * H * W tokens (`vae.py:113-134`):
    GroupNorm, to_q/to_k/to_v in the VAE's dtype, fp32 scores scaled by c^-1/2
    and softmax, to_out, residual; the scores in chunks of query rows."""

    def __init__(self, channels: int, groups: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.group_norm = ClipGroupNorm(channels, groups)
        self.to_q, self.to_k, self.to_v = (LoRADense(channels, channels, dtype=dtype) for _ in range(3))
        self.to_out = nn.ModuleList([LoRADense(channels, channels, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, t * h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        del y
        kt, vf = k.float().transpose(1, 2), v.float()
        n = q.shape[1]
        rows = max(1, min(n, ATTENTION_SCORE_ELEMENTS // max(n, 1)))
        out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
        for r0 in range(0, n, rows):
            scores = (q[:, r0:r0 + rows].float() * c ** -0.5) @ kt
            out[:, r0:r0 + rows] = (torch.softmax(scores, dim=-1) @ vf).to(q.dtype)
            del scores
        del q, kt, vf
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, t, h, w).to(x.dtype)


class HunyuanMidBlock3D(nn.Module):
    def __init__(self, dim: int, groups: int, add_attention: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([HunyuanResnetBlock3D(dim, dim, groups, dtype) for _ in range(2)])
        if add_attention:
            self.attentions = nn.ModuleList([HunyuanAttentionBlock(dim, groups, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x)
        return self.resnets[1](x)


class HunyuanDownsample3D(nn.Module):
    """A stride-(t, 2, 2) causal 3x3x3 conv (`vae.py:152-160`), its causal conv at `.conv`."""

    def __init__(self, dim: int, stride: Tuple[int, int, int], dtype: torch.dtype) -> None:
        super().__init__()
        self.conv = CausalConv3d(dim, dim, (3, 3, 3), stride, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class HunyuanUpsample3D(nn.Module):
    """Nearest x2 (frames 1.. doubled in time where `temporal`), then a causal
    3x3x3 conv (`vae.py:163-178`) that upsamples only the frames a run reads."""

    def __init__(self, dim: int, temporal: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.temporal = temporal
        self.conv = CausalConv3d(dim, dim, (3, 3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        read, shape = upsampled_reader(x, self.temporal)
        return self.conv(None, read, shape)


class HunyuanDownBlock3D(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int, groups: int,
                 stride: Optional[Tuple[int, int, int]], dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([HunyuanResnetBlock3D(in_dim if j == 0 else out_dim, out_dim, groups, dtype)
                                      for j in range(num_layers)])
        if stride is not None:
            self.downsamplers = nn.ModuleList([HunyuanDownsample3D(out_dim, stride, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class HunyuanUpBlock3D(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_layers: int, groups: int, upsample_temporal: Optional[bool],
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([HunyuanResnetBlock3D(in_dim if j == 0 else out_dim, out_dim, groups, dtype)
                                      for j in range(num_layers)])
        if upsample_temporal is not None:
            self.upsamplers = nn.ModuleList([HunyuanUpsample3D(out_dim, upsample_temporal, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


def _stages(cfg: HunyuanVAEConfig, i: int) -> Tuple[bool, bool]:
    """(spatial, temporal) resampling of block `i` (`vae.py:231-238`, :262-271; the
    decoder reuses the encoder's placement): spatial on the first log2(spatial
    ratio) blocks, temporal on the log2(temporal ratio) blocks before the last."""
    n = len(cfg.block_out_channels)
    num_spatial = int(math.log2(cfg.spatial_compression_ratio))
    num_time = int(math.log2(cfg.temporal_compression_ratio))
    return i < num_spatial, i >= (n - 1 - num_time) and i != n - 1


class HunyuanEncoder3D(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        g, boc = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], dtype=dtype)
        blocks = []
        for i, out_ch in enumerate(boc):
            spatial, temporal = _stages(cfg, i)
            stride = (2 if temporal else 1, 2 if spatial else 1, 2 if spatial else 1) if spatial or temporal else None
            blocks.append(HunyuanDownBlock3D(boc[max(i - 1, 0)], out_ch, cfg.layers_per_block, g, stride, dtype))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = HunyuanMidBlock3D(boc[-1], g, cfg.mid_block_add_attention, dtype)
        self.conv_norm_out = ClipGroupNorm(boc[-1], g)
        self.conv_out = CausalConv3d(boc[-1], 2 * cfg.latent_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x), post=silu_post))


class HunyuanDecoder3D(nn.Module):
    def __init__(self, cfg: HunyuanVAEConfig, dtype: torch.dtype) -> None:
        super().__init__()
        g, channels = cfg.norm_num_groups, tuple(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv3d(cfg.latent_channels, channels[0], dtype=dtype)
        self.mid_block = HunyuanMidBlock3D(channels[0], g, cfg.mid_block_add_attention, dtype)
        blocks = []
        for i, out_ch in enumerate(channels):
            spatial, temporal = _stages(cfg, i)
            upsample = temporal if i != len(channels) - 1 and (spatial or temporal) else None
            blocks.append(HunyuanUpBlock3D(channels[max(i - 1, 0)], out_ch, cfg.layers_per_block + 1, g, upsample,
                                           dtype))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = ClipGroupNorm(channels[-1], g)
        self.conv_out = CausalConv3d(channels[-1], cfg.out_channels, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, post=silu_post))


class AutoencoderKLHunyuanVideo(nn.Module):
    """Public boundary NCDHW (B, C, T, H, W), T = 1 + 4k frames; the moments
    and the decoded video are fp32 (`vae.py:283-313`)."""

    def __init__(self, config: HunyuanVAEConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = HunyuanEncoder3D(config, dtype)
        self.decoder = HunyuanDecoder3D(config, dtype)
        z = config.latent_channels
        self.quant_conv = ConvWeights(2 * z, 2 * z, (1, 1, 1), dtype)
        self.post_quant_conv = ConvWeights(z, z, (1, 1, 1), dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) in [-1, 1] -> moments (B, 2 latent, 1 + (T - 1) / 4, H / 8, W / 8)."""
        return self.quant_conv.pointwise(self.encoder(x.to(self.dtype))).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv.pointwise(z.to(self.dtype))).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode(x).chunk(2, dim=1)
        return self.decode(mean)
