"""Flow-matching and diffusion math (port of `finetrainers_tpu/functional/diffusion.py`).

Random draws come from a `torch.Generator`, or are given: `jax.random` and
torch generate different numbers from the same seed, so a caller that must
reproduce a JAX run hands over the JAX draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def flow_match_xt(x0: torch.Tensor, n: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward process of flow matching: interpolate data toward noise; `t`
    broadcasts against `x0`."""
    return (1.0 - t) * x0 + t * n


def flow_match_target(n: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Velocity target for flow matching."""
    return n - x0


def default_flow_shift(sigmas, shift: float = 1.0):
    """Timestep shift: sigma' = s*sigma / (1 + (s-1)*sigma)."""
    return (sigmas * shift) / (1.0 + (shift - 1.0) * sigmas)


def compute_density_for_timestep_sampling(
    weighting_scheme: str,
    batch_size: int,
    logit_mean: float = 0.0,
    logit_std: float = 1.0,
    mode_scale: float = 1.29,
    generator: Optional[torch.Generator] = None,
    draw: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Sample u in [0, 1) controlling which timesteps get trained (SD3 §3.1
    schemes). `draw` is the raw (batch_size,) draw, if given: standard normal
    for "logit_normal", uniform in [0, 1) otherwise; else it comes from
    `generator`."""
    if draw is None:
        sample = torch.randn if weighting_scheme == "logit_normal" else torch.rand
        draw = sample((batch_size,), generator=generator, device=device, dtype=torch.float32)
    draw = draw.to(device=device, dtype=torch.float32)
    if weighting_scheme == "logit_normal":
        return torch.sigmoid(logit_mean + logit_std * draw)
    if weighting_scheme == "mode":
        return 1.0 - draw - mode_scale * (torch.cos(math.pi * draw / 2.0) ** 2 - 1.0 + draw)
    return draw


def compute_loss_weighting(
    weighting_scheme: str,
    sigmas: Optional[torch.Tensor] = None,
    alphas: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sample loss weights: SD3's `sigma_sqrt` and `cosmap`, else ones; the
    DDIM path uses 1/(1-alpha)."""
    if alphas is not None:
        return 1.0 / (1.0 - alphas)
    if weighting_scheme == "sigma_sqrt":
        return (sigmas**-2.0).float()
    if weighting_scheme == "cosmap":
        bot = 1.0 - 2.0 * sigmas + 2.0 * sigmas**2
        return 2.0 / (math.pi * bot)
    return torch.ones_like(sigmas)
