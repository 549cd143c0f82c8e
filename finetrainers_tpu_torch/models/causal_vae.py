"""The pieces CogVideoX's and HunyuanVideo's causal 3D VAEs share (ports of
`finetrainers_tpu/models/cogvideox/vae.py` and `hunyuan_video/vae.py`).

  - A causal conv holds its weights one level down, as `.conv` (diffusers'
    `CogVideoXCausalConv3d` / `HunyuanVideoCausalConv3d` wrap an nn.Conv3d);
    it pads kt - 1 copies of frame 0 in front (REPLICATE, causal) and SAME
    zeros in space, then convolves VALID with its stride.
  - GroupNorm statistics are fp32 and cover the whole clip, (T, H, W, C / g),
    as torch's GroupNorm over a 5D tensor and flax's take them; the output is
    cast back to the input's dtype.
  - `nearest_indices` is `jax.image.resize(..., "nearest")`'s sampling, with
    half-pixel centres: output i reads input floor((i + 1/2) m / n), which is
    torch's "nearest-exact" and not its "nearest" where n / m is no integer.

Large activations: past `autoencoders.SPLIT_ELEMENTS` a conv runs in runs of
output frames, each from the input frames it reads (its kt - 1 frames before
them included), and a GroupNorm in runs of frames after its statistics are
summed over all of them; the input of a conv may be read lazily (an upsampler
upsamples only the frames a run reads). Each run computes what the single pass
computes for those frames; only the GroupNorm's fp32 sums are taken in another
order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import autoencoders

# (a, b) -> frames [a, b) of an NCDHW input
FrameReader = Callable[[int, int], torch.Tensor]


def frame_step(frames: int, elements: int) -> int:
    """Frames a run may hold so that `elements` (the whole op's) stays under SPLIT_ELEMENTS."""
    return autoencoders._pieces(frames, int(elements))


class ConvWeights(nn.Module):
    """A convolution's weight (out, in, *kernel) and bias in `dtype` (flax `nn.Conv`'s, torch's layout)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: Sequence[int], dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, *kernel, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight[0].numel() ** -0.5, generator=generator)
            self.bias.zero_()

    def pointwise(self, x: torch.Tensor) -> torch.Tensor:
        """The 1x1x1 conv of NCDHW `x` (in runs of frames past SPLIT_ELEMENTS)."""
        return causal_conv3d(tensor_reader(x), tuple(x.shape), self.weight, self.bias)


def causal_conv3d(read: FrameReader, shape: Tuple[int, int, int, int, int], weight: torch.Tensor,
                  bias: torch.Tensor, stride: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """The causal conv of the NCDHW input of `shape` that `read` gives: kt - 1
    copies of frame 0 in front, SAME zeros in space (odd kernels), VALID with
    `stride`; in runs of output frames past SPLIT_ELEMENTS."""
    b, c, t_in, h, w = shape
    kt, kh, kw = weight.shape[2:]
    st = stride[0]
    pad = kt - 1
    t_out = (t_in + pad - kt) // st + 1

    def frames(t0: int, t1: int) -> torch.Tensor:  # output frames [t0, t1) from the input frames they read
        lo, hi = t0 * st - pad, (t1 - 1) * st + kt - pad
        rows = read(max(lo, 0), hi).to(weight.dtype)
        if lo < 0:
            rows = torch.cat([rows[:, :, :1].expand(-1, -1, -lo, -1, -1), rows], dim=2)
        return F.conv3d(rows, weight, bias, stride=tuple(stride), padding=(0, kh // 2, kw // 2))

    step = frame_step(t_out, b * c * t_in * h * w * max(weight.shape[0] / c, 1.0))
    if step >= t_out:
        return frames(0, t_out)
    first = frames(0, step)
    out = torch.empty((*first.shape[:2], t_out, *first.shape[3:]), dtype=first.dtype, device=first.device)
    out[:, :, :step] = first
    del first
    for t0 in range(step, t_out, step):
        t1 = min(t0 + step, t_out)
        out[:, :, t0:t1] = frames(t0, t1)
    return out


def tensor_reader(x: torch.Tensor) -> FrameReader:
    return lambda a, b: x[:, :, a:b]


class CausalConv3d(nn.Module):
    """`HunyuanVideoCausalConv3d` / `CogVideoXCausalConv3d`: the weights at `.conv`, REPLICATE causal time pad."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: Sequence[int] = (3, 3, 3),
                 stride: Sequence[int] = (1, 1, 1), dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = ConvWeights(in_dim, out_dim, kernel_size, dtype)
        self.stride = tuple(stride)

    def forward(self, x: torch.Tensor, read: Optional[FrameReader] = None,
                shape: Optional[Tuple[int, int, int, int, int]] = None) -> torch.Tensor:
        """`x` NCDHW, or None with `read` and the `shape` of the input it reads lazily."""
        if x is not None:
            read, shape = tensor_reader(x), tuple(x.shape)
        return causal_conv3d(read, shape, self.conv.weight, self.conv.bias, self.stride)


def nearest_indices(m: int, n: int, device: torch.device) -> torch.Tensor:
    """The input index each of `n` outputs reads when `jax.image.resize` takes
    `m` samples to `n` "nearest": floor((i + 1/2) m / n), in integers."""
    return (2 * torch.arange(n, device=device) + 1) * m // (2 * n)


def resize_frames_2d(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCDHW `frames` resized in space to `size`, half-pixel nearest (torch's "nearest-exact")."""
    b, c, t, h, w = frames.shape
    if (h, w) == tuple(size):
        return frames
    flat = frames.transpose(1, 2).reshape(b * t, c, h, w)
    flat = F.interpolate(flat, size=tuple(size), mode="nearest-exact")
    return flat.reshape(b, t, c, *size).transpose(1, 2)


class ClipGroupNorm(nn.Module):
    """GroupNorm over the whole clip in fp32 (eps 1e-6), fp32 affine parameters,
    the output in the input's dtype. `forward(x, post=)` hands each normalised
    run of frames (t0, t1, y) to `post` (a modulation, an activation) and writes
    what it returns, so nothing of the input's size is made in fp32."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.groups, self.eps = min(groups, channels), eps
        self.weight = nn.Parameter(torch.empty(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(channels, dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor,
                post: Optional[Callable[[int, int, torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        b, c, t = x.shape[:3]
        step = frame_step(t, 4 * x.numel())
        if step >= t:
            y = F.group_norm(x.float(), self.groups, self.weight, self.bias, self.eps).to(x.dtype)
            return y if post is None else post(0, t, y)
        g = self.groups
        count = x.numel() // (b * g)
        total = torch.zeros((b, g), dtype=torch.float32, device=x.device)
        for t0 in range(0, t, step):
            total += x[:, :, t0:t0 + step].float().reshape(b, g, -1).sum(-1)
        mean = total / count
        total.zero_()
        for t0 in range(0, t, step):
            total += (x[:, :, t0:t0 + step].float().reshape(b, g, -1) - mean[..., None]).square().sum(-1)
        rstd = torch.rsqrt(total / count + self.eps)
        out = torch.empty_like(x)
        w, bias = self.weight.reshape(1, c, 1, 1, 1), self.bias.reshape(1, c, 1, 1, 1)
        for t0 in range(0, t, step):
            t1 = min(t0 + step, t)
            run = x[:, :, t0:t1].float()
            y = ((run.reshape(b, g, -1) - mean[..., None]) * rstd[..., None]).reshape(run.shape)
            y = (y * w + bias).to(x.dtype)
            del run
            out[:, :, t0:t1] = y if post is None else post(t0, t1, y)
        return out


def silu_post(t0: int, t1: int, y: torch.Tensor) -> torch.Tensor:
    return F.silu(y)


def upsampled_reader(x: torch.Tensor, temporal: bool) -> Tuple[FrameReader, Tuple[int, int, int, int, int]]:
    """The decoders' upsampling of NCDHW `x`, read lazily: frame 0 upsampled in
    space only and frames 1.. in time and space (T -> 1 + 2 (T - 1)) where
    `temporal` and T > 1, else every frame in space only; nearest x2, which is
    half-pixel nearest at an integer ratio. Returns the reader and its shape."""
    b, c, t, h, w = x.shape
    t_out = 1 + 2 * (t - 1) if temporal and t > 1 else t

    def read(a: int, e: int) -> torch.Tensor:
        idx = torch.arange(a, e, device=x.device)
        if t_out != t:
            idx = torch.where(idx == 0, idx, 1 + (idx - 1) // 2)
        frames = x.index_select(2, idx)
        n = frames.shape[2]
        flat = frames.transpose(1, 2).reshape(b * n, c, h, w)
        flat = F.interpolate(flat, scale_factor=2.0, mode="nearest")
        return flat.reshape(b, n, c, 2 * h, 2 * w).transpose(1, 2)

    return read, (b, c, t_out, 2 * h, 2 * w)
