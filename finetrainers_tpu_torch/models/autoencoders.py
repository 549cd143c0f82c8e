"""Causal 3D convolutional VAE (port of `finetrainers_tpu/models/autoencoders.py`).

The same configurable autoencoder the JAX package uses when no checkpoint of a
family's real VAE is present: temporally causal convolutions (frame t sees only
frames <= t, the front padded with copies of the first frame), per-frame
GroupNorm, and first-frame-preserving temporal down/upsampling. Layout is
NCDHW throughout (the JAX package runs NDHWC inside and NCDHW at its public
boundary). Module names equal the flax names, so `load_flax_vae_params` maps
a flattened flax tree onto the state dict by renaming only the leaves.

Large activations. At 81x480x832 the Wan config's full-resolution stage holds
96 channels of 81x480x832 (3.1e9 elements, past 2^31). On the H100 (torch
2.11, cuDNN 9.2) no op fails there, but one bf16 conv3d of that size
allocates 25 GB beside its input and the whole decode 54 GB
(`tools/torch_vae_large.py`), so it would not fit beside a 14B transformer's
33 GB. Past
`SPLIT_ELEMENTS`, a causal conv therefore runs in strips of output rows, each
from its input rows and a halo of kh - 1 (upsampling its own rows first where
the decoder upsamples into the conv), and a GroupNorm in runs of frames. Both
are exact: a SAME-padded conv's output row depends only on those input rows,
and the GroupNorm's statistics are per frame. Spatial tiles of the whole
decoder would not be (its statistics span the frame).
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

# Copied from `finetrainers_tpu/models/autoencoders.py:314-320`: the generic VAE CogVideoX trains and serves with
# when no `AutoencoderKLCogVideoX` checkpoint is present. At 81x480x768 its full-resolution stage holds
# 128 x 81 x 480 x 768 = 3.82e9 elements, past SPLIT_ELEMENTS, so its convs there run in row strips.
COGVIDEOX_VAE_CONFIG = AutoencoderConfig(
    latent_channels=16,
    block_out_channels=(128, 256, 256, 512),
    layers_per_block=3,
    spatial_downsample=(True, True, True),  # 8x spatial
    temporal_downsample=(False, True, True),  # 4x temporal
)

# Copied from `finetrainers_tpu/models/autoencoders.py:322-328`: the generic VAE HunyuanVideo serves and trains
# with when no `AutoencoderKLHunyuanVideo` checkpoint is present. At 49x480x768 its full-resolution stage holds
# 128 x 49 x 480 x 768 = 2.31e9 elements, past SPLIT_ELEMENTS, so its convs there run in row strips.
HUNYUAN_VAE_CONFIG = AutoencoderConfig(
    latent_channels=16,
    block_out_channels=(128, 256, 512, 512),
    layers_per_block=2,
    spatial_downsample=(True, True, True),  # 8x spatial
    temporal_downsample=(False, True, True),  # 4x temporal
)

# 2D image VAEs (Flux): the temporal-degenerate config, copied from
# `finetrainers_tpu/models/autoencoders.py:330-337`. At 1024x1024 its largest
# operand, the last upsampling conv's causally padded 256-channel input
# (256 x 3 x 1026 x 1026 = 8.08e8 elements), stays under SPLIT_ELEMENTS, so
# it runs unsplit (`chip_smoke.py`'s flux_serve checks this).
SD_VAE_CONFIG = AutoencoderConfig(
    latent_channels=16,
    block_out_channels=(128, 256, 512, 512),
    layers_per_block=2,
    spatial_downsample=(True, True, True),  # 8x spatial
    temporal_downsample=(False, False, False),
)


# A convolution whose input or output, or a GroupNorm whose input, holds more
# elements than this runs in pieces (see the module's docstring). The tests
# lower it to force the split at small sizes.
SPLIT_ELEMENTS = 1 << 30


def _pieces(size: int, elements: int) -> int:
    """The length of a piece along a dim of `size` that keeps `elements` under SPLIT_ELEMENTS."""
    return size if elements <= SPLIT_ELEMENTS else max(1, size * SPLIT_ELEMENTS // elements)


def _upsample(x: torch.Tensor, temporal: bool, spatial: bool) -> torch.Tensor:
    """The decoder's nearest upsampling: frames after the first repeated twice
    (the first stays single, keeping the VAE causal), rows and columns twice."""
    if temporal:
        x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
    if spatial:
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return x


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
    """Temporal: causal (front padded with copies of frame 0); spatial: SAME.
    `temporal_up`/`spatial_up` upsample the input first (`_upsample`). Past
    SPLIT_ELEMENTS the conv runs in strips of output rows (`_rows`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3), stride=(1, 1, 1),
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, kernel_size, stride, dtype=dtype)

    def forward(self, x: torch.Tensor, temporal_up: bool = False, spatial_up: bool = False) -> torch.Tensor:
        kt, kh, kw = self.conv.kernel_size
        st, sh, sw = self.conv.stride
        b, _, t, h, w = x.shape
        t_in, h_in, w_in = (2 * t - 1 if temporal_up else t), h * (1 + spatial_up), w * (1 + spatial_up)
        out_shape = (b, self.conv.weight.shape[0], (t_in - 1) // st + 1, (h_in - 1) // sh + 1, (w_in - 1) // sw + 1)
        elements = max(b * x.shape[1] * (t_in + kt - 1) * (h_in + kh - 1) * (w_in + kw - 1), int(np.prod(out_shape)))
        strip = _pieces(out_shape[3], elements)
        if strip >= out_shape[3]:
            return self._rows(x, 0, out_shape[3], h_in, temporal_up, spatial_up)
        out = torch.empty(out_shape, dtype=self.conv.weight.dtype, device=x.device)
        for r0 in range(0, out_shape[3], strip):
            r1 = min(r0 + strip, out_shape[3])
            out[:, :, :, r0:r1] = self._rows(x, r0, r1, h_in, temporal_up, spatial_up)
        return out

    def _rows(self, x: torch.Tensor, r0: int, r1: int, h_in: int, temporal_up: bool,
              spatial_up: bool) -> torch.Tensor:
        """Output rows [r0, r1) (all of them for an unsplit conv): the
        (upsampled) input rows they read, with zero rows where they reach into
        the SAME padding."""
        kt, kh, kw = self.conv.kernel_size
        sh = self.conv.stride[1]
        lo = r0 * sh - (kh - 1) // 2
        hi = (r1 - 1) * sh + kh - (kh - 1) // 2
        lo_in, hi_in = max(lo, 0), min(hi, h_in)
        if spatial_up:
            src = lo_in // 2
            rows = _upsample(x[:, :, :, src:(hi_in + 1) // 2], temporal_up, True)[:, :, :, lo_in - 2 * src:hi_in - 2 * src]
        else:
            rows = _upsample(x[:, :, :, lo_in:hi_in], temporal_up, False)
        if kt > 1:
            rows = torch.cat([rows[:, :, :1].expand(-1, -1, kt - 1, -1, -1), rows], dim=2)
        return self.conv(F.pad(rows, ((kw - 1) // 2, kw // 2, lo_in - lo, hi - hi_in)))


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
        frames = _pieces(x.shape[2], x.numel())
        if frames >= x.shape[2]:
            return self._frames(x)
        out = torch.empty_like(x)
        for t0 in range(0, x.shape[2], frames):
            out[:, :, t0:t0 + frames] = self._frames(x[:, :, t0:t0 + frames])
        return out

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
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
                # Causal temporal upsample (the first frame stays single) and
                # spatial, inside the conv so a split conv upsamples its strips only.
                h = getattr(self, f"up_{i}_upsample")(h, temporal_up=self.up_temporal[i],
                                                      spatial_up=self.up_spatial[i])
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


def _is_2d(vae_handle: ModelHandle) -> bool:
    """Whether the handle holds the 2D `AutoencoderKL` (a checkpoint's image
    VAE); else it must hold a 3D VAE (the generic one, `AutoencoderKLWan`,
    `AutoencoderKLLTXVideo`, `AutoencoderKLCogVideoX` or
    `AutoencoderKLHunyuanVideo`), or this raises."""
    from .autoencoder_kl import AutoencoderKL
    from .cogvideox.vae import AutoencoderKLCogVideoX
    from .hunyuan_video.vae import AutoencoderKLHunyuanVideo
    from .ltx_video.vae import AutoencoderKLLTXVideo
    from .wan.vae import AutoencoderKLWan

    if isinstance(vae_handle.module, AutoencoderKL):
        return True
    if not isinstance(vae_handle.module, (AutoencoderKL3D, AutoencoderKLWan, AutoencoderKLLTXVideo,
                                          AutoencoderKLCogVideoX, AutoencoderKLHunyuanVideo)):
        raise NotImplementedError(f"{type(vae_handle.module).__name__}: the port's image VAEs are the 3D VAEs and "
                                  "the 2D AutoencoderKL; see ROADMAP.md queue 1 item 5 (loading diffusers "
                                  "checkpoints)")
    return False


@torch.no_grad()
def encode_image_vae(vae_handle: ModelHandle, x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) images in [-1, 1] -> moments (B, 2C, H', W') through the 2D
    `AutoencoderKL`, or the 3D VAE as single-frame videos (JAX
    autoencoders.py:264-274). Neither slicing nor tiling applies, as in JAX."""
    if _is_2d(vae_handle):
        return vae_handle.module.encode(x)
    return vae_handle.module.encode(x[:, :, None])[:, :, 0]


@torch.no_grad()
def decode_image_vae(vae_handle: ModelHandle, z: torch.Tensor) -> torch.Tensor:
    """(B, C, H', W') latents -> (B, 3, H, W) fp32 through either VAE (JAX
    autoencoders.py:277-286)."""
    if _is_2d(vae_handle):
        return vae_handle.module.decode(z)
    return vae_handle.module.decode(z[:, :, None])[:, :, 0]


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


def generic_vae(spec: ModelSpecification, config: AutoencoderConfig) -> ModelHandle:
    """The generic `AutoencoderKL3D` with `config` on `spec`'s device, random
    weights from `spec.generator()`, identity latent statistics: the VAE the
    JAX package serves with when no local `vae/` directory of the family's
    real VAE exists (each spec loads one where it does)."""
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
