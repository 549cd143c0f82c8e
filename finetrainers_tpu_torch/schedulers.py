"""Flow-matching Euler scheduler (port of the parts of `finetrainers_tpu/schedulers.py`
that serving and the training step run).

Inference sigma grids are computed on the host in numpy, as in the JAX
package, so the two packages produce identical grids; the per-step update and
the training sigmas run on tensors.
The multistep samplers (UniPC, DPM-Solver++) and the DDIM scheduler are not
ported yet (ROADMAP.md); `load_scheduler` raises for a checkpoint naming one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from .functional.diffusion import compute_density_for_timestep_sampling, default_flow_shift


@dataclasses.dataclass
class FlowMatchEulerScheduler:
    """diffusers FlowMatchEulerDiscreteScheduler semantics: sigmas = t/N for
    t = N..1, optional static shift."""

    num_train_timesteps: int = 1000
    shift: float = 1.0
    use_dynamic_shifting: bool = False

    @property
    def sigmas(self) -> torch.Tensor:
        ts = torch.arange(self.num_train_timesteps, 0, -1, dtype=torch.float32)
        sigmas = ts / self.num_train_timesteps
        if not self.use_dynamic_shifting:
            sigmas = default_flow_shift(sigmas, self.shift)
        return sigmas

    def training_sigmas(
        self,
        batch_size: int,
        flow_weighting_scheme: str = "none",
        flow_logit_mean: float = 0.0,
        flow_logit_std: float = 1.0,
        flow_mode_scale: float = 1.29,
        generator: Optional[torch.Generator] = None,
        draw: Optional[torch.Tensor] = None,
        device=None,
    ) -> torch.Tensor:
        """Per-example training sigmas (`training_sigmas`, JAX :62-77): the
        sigma table at index floor(u * N), u from the weighting scheme's density
        with the raw `draw` given or taken from `generator`."""
        u = compute_density_for_timestep_sampling(
            flow_weighting_scheme, batch_size, flow_logit_mean, flow_logit_std, flow_mode_scale,
            generator=generator, draw=draw, device=device,
        )
        indices = (u * self.num_train_timesteps).to(torch.int32).clamp(0, self.num_train_timesteps - 1)
        return self.sigmas.to(u.device)[indices.long()]

    def inference_sigmas(self, num_steps: int, shift: Optional[float] = None, mu: Optional[float] = None) -> np.ndarray:
        sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float32)
        if mu is not None:
            sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
        else:
            s = self.shift if shift is None else shift
            sigmas = s * sigmas / (1.0 + (s - 1.0) * sigmas)
        return np.concatenate([sigmas, [0.0]]).astype(np.float32)

    def step(self, model_output: torch.Tensor, sigma: float, sigma_next: float, sample: torch.Tensor) -> torch.Tensor:
        """Euler step: x_{t-1} = x_t + (sigma_next - sigma) * v."""
        return sample + (sigma_next - sigma) * model_output

    def make_sampler(self, sigmas: np.ndarray) -> "_EulerSampler":
        """Sampler for one denoise run over the given sigma grid (num_steps + 1
        entries, trailing 0.0): `update(pred, i, sample)` advances the sample
        from sigmas[i] to sigmas[i+1]."""
        return _EulerSampler(np.asarray(sigmas, np.float64))


class _EulerSampler:
    def __init__(self, sigmas: np.ndarray):
        self.sigmas = sigmas

    def update(self, pred: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
        # The step size is rounded to fp32 first, as the JAX package's _combine does.
        dt = float(np.float32(self.sigmas[i + 1] - self.sigmas[i]))
        return sample + dt * pred


def load_scheduler(pretrained_model_name_or_path: Optional[str], default):
    """The checkpoint's own scheduler from `<path>/scheduler/scheduler_config.json`,
    else `default`. Only FlowMatchEulerDiscreteScheduler is ported; a config
    naming a multistep sampler raises, any other name keeps `default` (as the
    JAX package does for names it does not map)."""
    if not pretrained_model_name_or_path:
        return default
    cfg_path = os.path.join(str(pretrained_model_name_or_path), "scheduler", "scheduler_config.json")
    if not os.path.isfile(cfg_path):
        return default
    with open(cfg_path) as f:
        cfg = json.load(f)
    name = cfg.get("_class_name", "")
    if name == "FlowMatchEulerDiscreteScheduler":
        return FlowMatchEulerScheduler(
            num_train_timesteps=int(cfg.get("num_train_timesteps", 1000)),
            shift=float(cfg.get("shift", cfg.get("flow_shift", getattr(default, "shift", 1.0)))),
            use_dynamic_shifting=bool(cfg.get("use_dynamic_shifting", getattr(default, "use_dynamic_shifting", False))),
        )
    if name in ("UniPCMultistepScheduler", "FlowUniPCMultistepScheduler",
                "DPMSolverMultistepScheduler", "FlowDPMSolverMultistepScheduler"):
        raise NotImplementedError(f"scheduler {name!r} is not ported yet; see ROADMAP.md")
    return default
