"""Schedulers (port of `finetrainers_tpu/schedulers.py`): flow-matching Euler,
the UniPC and DPM-Solver++ multistep samplers, and CogVideoX's DDIM.

Inference sigma grids and every per-step solver coefficient are computed on
the host in float64 numpy, copied from the JAX package, so the two packages
produce identical grids and coefficients; the device work of a step is one
linear combination of the sample and the x0-prediction history, in fp32 with
fp32 coefficients, as JAX's `_combine` does. A sampler is made per denoise run
(`scheduler.make_sampler(sigmas)`) and holds that run's history itself.
`CogVideoXDDIMScheduler` is the training side of CogVideoX's DDIM (its
alpha-bar table, computed in float64 as JAX computes it and held in fp32);
its sampler is the pipeline's (`models/cogvideox/pipeline.py`).
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


@dataclasses.dataclass
class CogVideoXDDIMScheduler:
    """CogVideoX's DDIM training surface (JAX :102-157): scaled-linear betas,
    the SNR shift and the zero-terminal-SNR rescale, in float64 numpy as JAX
    computes them, then held as fp32."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True

    def __post_init__(self):
        betas = np.linspace(self.beta_start**0.5, self.beta_end**0.5, self.num_train_timesteps, dtype=np.float64) ** 2
        alphas_cumprod = np.cumprod(1.0 - betas)
        # SNR shift: alpha' = alpha / (scale - (scale - 1) * alpha)
        alphas_cumprod = alphas_cumprod / (self.snr_shift_scale - (self.snr_shift_scale - 1.0) * alphas_cumprod)
        if self.rescale_betas_zero_snr:
            # Lin et al. 2023, zero terminal SNR: rescale sqrt(alpha_bar)
            sqrt_ac = np.sqrt(alphas_cumprod)
            sqrt_ac_0, sqrt_ac_T = sqrt_ac[0].copy(), sqrt_ac[-1].copy()
            sqrt_ac -= sqrt_ac_T
            sqrt_ac *= sqrt_ac_0 / (sqrt_ac_0 - sqrt_ac_T)
            alphas_cumprod = sqrt_ac**2
        self._alphas_cumprod = torch.from_numpy(alphas_cumprod.astype(np.float32))

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        return self._alphas_cumprod

    @property
    def alphas(self) -> torch.Tensor:
        return self._alphas_cumprod

    @property
    def sigmas(self) -> torch.Tensor:
        """t / N for t = N-1..0 in fp32, so that (sigma * N) truncated gives t back (JAX :131-137)."""
        ts = torch.arange(self.num_train_timesteps - 1, -1, -1, dtype=torch.float32)
        return ts / self.num_train_timesteps

    def timesteps(self, sigmas: torch.Tensor) -> torch.Tensor:
        """int64 clip(int32(sigma * N), 0, N-1), the product in fp32 as JAX forms it (trainer :272-275)."""
        t = (sigmas.float() * self.num_train_timesteps).to(torch.int32)
        return t.clamp(0, self.num_train_timesteps - 1).long()

    def training_sigmas(self, batch_size: int, generator: Optional[torch.Generator] = None,
                        draw: Optional[torch.Tensor] = None, device=None, **_) -> torch.Tensor:
        """Per-example sigmas at uniform indices whatever the weighting scheme
        (JAX :142-145 ignores it): `draw` is the raw uniform (B,) draw, else it
        comes from `generator`."""
        if draw is None:
            draw = torch.rand((batch_size,), generator=generator, device=device, dtype=torch.float32)
        u = draw.to(device=device, dtype=torch.float32)
        indices = (u * self.num_train_timesteps).to(torch.int32).clamp(0, self.num_train_timesteps - 1)
        return self.sigmas.to(u.device)[indices.long()]

    def add_noise(self, latents: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """sqrt(a_t) x + sqrt(1 - a_t) noise, a_t broadcast per example (JAX :151-155)."""
        a = self._alphas_cumprod.to(latents.device)[timesteps.long()]
        a = a.reshape(a.shape + (1,) * (latents.ndim - a.ndim))
        return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise


def _combine(coeffs, *tensors: torch.Tensor) -> torch.Tensor:
    """sum_k coeffs[k] * tensors[k], each coefficient rounded to fp32 first and
    the terms added in order (JAX `_combine`, :186-199)."""
    coeffs = np.asarray(coeffs, np.float32)
    out = float(coeffs[0]) * tensors[0]
    for c, t in zip(coeffs[1:], tensors[1:]):
        out = out + float(c) * t
    return out


class _EulerSampler:
    def __init__(self, sigmas: np.ndarray):
        self.sigmas = sigmas

    def update(self, pred: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
        # The step size is rounded to fp32 first, as the JAX package's _combine does.
        dt = float(np.float32(self.sigmas[i + 1] - self.sigmas[i]))
        return sample + dt * pred


# ============================================================ multistep samplers
#
# Copied from JAX `schedulers.py:163-314`: the solver math is in lambda =
# log(alpha/sigma) space with the flow parameterization alpha = 1 - sigma; the
# model's velocity converts to a data prediction as x0 = x - sigma * v.


def _flow_lambda(sigma: np.ndarray) -> np.ndarray:
    """lambda_t = log(alpha_t) - log(sigma_t) with alpha = 1 - sigma (flow).
    -inf at sigma=1 and +inf at sigma=0 are limits the order-1 formulas pass
    through exactly (expm1(-inf) = -1)."""
    sigma = np.asarray(sigma, np.float64)
    with np.errstate(divide="ignore"):
        return np.log1p(-sigma) - np.log(sigma)


def _unipc_Rb(order: int, rks: np.ndarray, hh: float, solver_type: str):
    """The UniPC B(h) linear system: R[i-1] = rks**(i-1), b[i-1] = i! *
    phi_{i+1}(hh) / B(h), by the recurrence h_phi_{k+1} = h_phi_k / hh - 1/(k+1)!."""
    R, b = [], []
    h_phi_1 = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1.0
    fact = 1.0
    B_h = hh if solver_type == "bh1" else np.expm1(hh)
    for i in range(1, order + 1):
        R.append(rks ** (i - 1))
        b.append(h_phi_k * fact / B_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    return np.stack(R), np.asarray(b), h_phi_1, B_h


def _uni_p_coeffs(sigmas: np.ndarray, i: int, order: int, solver_type: str = "bh2") -> np.ndarray:
    """Predictor (UniP) coefficients stepping sigmas[i] -> sigmas[i+1] given the
    x0-prediction history [m0 (at i), m1 (at i-1), ..., m_{order-1}]:
    prev = c[0]*sample + c[1]*m0 + ... + c[order]*m_{order-1}."""
    sigmas = np.asarray(sigmas, np.float64)
    sigma_t, sigma_s0 = sigmas[i + 1], sigmas[i]
    if sigma_t == 0.0:
        # Final step: the h -> inf limit of the order-1 update is exactly m0.
        return np.concatenate([[0.0, 1.0], np.zeros(order - 1)])
    alpha_t = 1.0 - sigma_t
    lam_t, lam_s0 = _flow_lambda(sigma_t), _flow_lambda(sigma_s0)
    h = lam_t - lam_s0
    hh = -h  # predict_x0 convention
    # History points at sigma exactly 1 or 0 (lambda = -inf/+inf) carry no
    # multistep information: the order is capped to the finite-lambda suffix.
    req_order = order
    while order > 1 and not np.isfinite(_flow_lambda(sigmas[i - (order - 1)])):
        order -= 1
    rks = np.asarray([(_flow_lambda(sigmas[i - k]) - lam_s0) / h for k in range(1, order)], np.float64)
    R, b, h_phi_1, B_h = _unipc_Rb(order, np.concatenate([rks, [1.0]]), hh, solver_type)
    if order == 1:
        rhos_p = np.zeros(0)
    elif order == 2:
        rhos_p = np.asarray([0.5])
    else:
        rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
    coeffs = np.zeros(req_order + 1, np.float64)
    coeffs[0] = sigma_t / sigma_s0
    coeffs[1] = -alpha_t * h_phi_1
    for k in range(1, order):  # residual terms on D1s_k = (m_k - m0) / rks_k
        w = -alpha_t * B_h * rhos_p[k - 1] / rks[k - 1]
        coeffs[k + 1] += w
        coeffs[1] -= w
    return coeffs


def _uni_c_coeffs(sigmas: np.ndarray, i: int, order: int, solver_type: str = "bh2") -> np.ndarray:
    """Corrector (UniC) coefficients refining the step sigmas[i-1] -> sigmas[i],
    given history [m0 (at i-1), ..., m_{order-1}] and the fresh prediction x0_t
    at sigmas[i]: corrected = c[0]*last_sample + c[1]*m0 + ... +
    c[order]*m_{order-1} + c[order+1]*x0_t."""
    sigmas = np.asarray(sigmas, np.float64)
    sigma_t, sigma_s0 = sigmas[i], sigmas[i - 1]
    alpha_t = 1.0 - sigma_t
    lam_t, lam_s0 = _flow_lambda(sigma_t), _flow_lambda(sigma_s0)
    h = lam_t - lam_s0
    hh = -h
    req_order = order
    while order > 1 and not np.isfinite(_flow_lambda(sigmas[i - 1 - (order - 1)])):
        order -= 1
    rks = np.asarray([(_flow_lambda(sigmas[i - 1 - k]) - lam_s0) / h for k in range(1, order)], np.float64)
    R, b, h_phi_1, B_h = _unipc_Rb(order, np.concatenate([rks, [1.0]]), hh, solver_type)
    if order == 1:
        rhos_c = np.asarray([0.5])
    else:
        rhos_c = np.linalg.solve(R, b)
    coeffs = np.zeros(req_order + 2, np.float64)
    coeffs[0] = sigma_t / sigma_s0
    coeffs[1] = -alpha_t * h_phi_1
    for k in range(1, order):
        w = -alpha_t * B_h * rhos_c[k - 1] / rks[k - 1]
        coeffs[k + 1] += w
        coeffs[1] -= w
    w_t = -alpha_t * B_h * rhos_c[-1]  # on D1_t = x0_t - m0
    coeffs[req_order + 1] = w_t  # the x0_t slot stays last
    coeffs[1] -= w_t
    return coeffs


def _dpm_coeffs(sigmas: np.ndarray, i: int, order: int) -> np.ndarray:
    """DPM-Solver++(2M) coefficients stepping sigmas[i] -> sigmas[i+1] with
    history [m0 (at i), m1 (at i-1)]: prev = c[0]*sample + c[1]*m0 + c[2]*m1."""
    sigmas = np.asarray(sigmas, np.float64)
    sigma_t, sigma_s0 = sigmas[i + 1], sigmas[i]
    if sigma_t == 0.0:
        return np.asarray([0.0, 1.0, 0.0])
    alpha_t = 1.0 - sigma_t
    lam_t, lam_s0 = _flow_lambda(sigma_t), _flow_lambda(sigma_s0)
    h = lam_t - lam_s0
    base = -alpha_t * np.expm1(-h)
    coeffs = np.asarray([sigma_t / sigma_s0, base, 0.0])
    if order >= 2:
        h_last = lam_s0 - _flow_lambda(sigmas[i - 1])
        r0 = h_last / h
        coeffs[1] = base * (1.0 + 1.0 / (2.0 * r0))
        coeffs[2] = base * (-1.0 / (2.0 * r0))
    return coeffs


class UniPCSampler:
    """UniPC predictor-corrector over one sigma grid (JAX :317-365).

    Step i: (1) the velocity at sigmas[i] becomes x0; (2) the previous
    predictor output is corrected with this fresh evaluation (UniC); (3) the
    sample at sigmas[i+1] is predicted from the corrected sample and the x0
    history (UniP). The history holds the uncorrected conversions; the
    predictor's order ramps up over the first steps and, with
    `lower_order_final`, down at the tail, so the last step is the exact
    order-1 limit. `pred` is the guided prediction under CFG."""

    def __init__(self, sigmas, solver_order=2, solver_type="bh2", lower_order_final=True, use_corrector=True):
        self.sigmas = np.asarray(sigmas, np.float64)
        self.solver_order = int(solver_order)
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.use_corrector = use_corrector
        self.history: list = []  # x0 predictions, the most recent last
        self.last_sample = None
        self.this_order = 1  # the order the next corrector call uses

    def update(self, pred: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
        x0 = _combine([1.0, -float(self.sigmas[i])], sample, pred)
        if i > 0 and self.use_corrector and self.last_sample is not None:
            order = min(self.this_order, len(self.history))
            coeffs = _uni_c_coeffs(self.sigmas, i, order, self.solver_type)
            sample = _combine(coeffs, self.last_sample, *self.history[::-1][:order], x0)
        self.history.append(x0)
        if len(self.history) > self.solver_order:
            self.history.pop(0)
        order = min(self.solver_order, len(self.history))
        if self.lower_order_final:
            order = min(order, len(self.sigmas) - 1 - i)
        self.this_order = order
        self.last_sample = sample
        coeffs = _uni_p_coeffs(self.sigmas, i, order, self.solver_type)
        return _combine(coeffs, sample, *self.history[::-1][:order])


class DPMSolverSampler:
    """DPM-Solver++(2M): second-order multistep on the x0 history, no
    corrector (JAX :368-389)."""

    def __init__(self, sigmas, solver_order=2, lower_order_final=True):
        self.sigmas = np.asarray(sigmas, np.float64)
        self.solver_order = min(int(solver_order), 2)
        self.lower_order_final = lower_order_final
        self.history: list = []

    def update(self, pred: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
        x0 = _combine([1.0, -float(self.sigmas[i])], sample, pred)
        self.history.append(x0)
        if len(self.history) > 2:
            self.history.pop(0)
        order = min(self.solver_order, len(self.history))
        if self.lower_order_final:
            order = min(order, len(self.sigmas) - 1 - i)
        coeffs = _dpm_coeffs(self.sigmas, i, order)
        ms = (self.history[::-1] + [self.history[-1]])[:2]  # m1 repeats m0 where the order is 1 (c[2] = 0)
        return _combine(coeffs, sample, *ms)


@dataclasses.dataclass
class UniPCFlowScheduler(FlowMatchEulerScheduler):
    """Flow-matching UniPC (diffusers `UniPCMultistepScheduler` with
    prediction_type='flow_prediction', the scheduler Wan 2.1 checkpoints name;
    JAX :392-406). Training is flow-match Euler's; inference the
    predictor-corrector."""

    solver_order: int = 2
    solver_type: str = "bh2"
    lower_order_final: bool = True
    use_corrector: bool = True

    def make_sampler(self, sigmas: np.ndarray) -> UniPCSampler:
        return UniPCSampler(sigmas, self.solver_order, self.solver_type, self.lower_order_final, self.use_corrector)


@dataclasses.dataclass
class DPMSolverFlowScheduler(FlowMatchEulerScheduler):
    """Flow-matching DPM-Solver++(2M) (diffusers `DPMSolverMultistepScheduler`,
    algorithm_type='dpmsolver++'; JAX :409-418)."""

    solver_order: int = 2
    lower_order_final: bool = True

    def make_sampler(self, sigmas: np.ndarray) -> DPMSolverSampler:
        return DPMSolverSampler(sigmas, self.solver_order, self.lower_order_final)


def load_scheduler(pretrained_model_name_or_path: Optional[str], default):
    """The checkpoint's own scheduler from `<path>/scheduler/scheduler_config.json`,
    its `_class_name` mapped as JAX `load_scheduler` maps it (:421-470), the
    family default's shift kept where the config has none; `default` where the
    path or the file is absent or the name unknown. A DDIM config gives a
    `CogVideoXDDIMScheduler` under a DDIM default (CogVideoX) and keeps a
    flow-matching default, as JAX does (:456-468)."""
    if not pretrained_model_name_or_path:
        return default
    cfg_path = os.path.join(str(pretrained_model_name_or_path), "scheduler", "scheduler_config.json")
    if not os.path.isfile(cfg_path):
        return default
    with open(cfg_path) as f:
        cfg = json.load(f)
    name = cfg.get("_class_name", "")
    common = dict(
        num_train_timesteps=int(cfg.get("num_train_timesteps", 1000)),
        shift=float(cfg.get("shift", cfg.get("flow_shift", getattr(default, "shift", 1.0)))),
        use_dynamic_shifting=bool(cfg.get("use_dynamic_shifting", getattr(default, "use_dynamic_shifting", False))),
    )
    if name in ("UniPCMultistepScheduler", "FlowUniPCMultistepScheduler"):
        return UniPCFlowScheduler(
            **common,
            solver_order=int(cfg.get("solver_order", 2)),
            solver_type=str(cfg.get("solver_type", "bh2")),
            lower_order_final=bool(cfg.get("lower_order_final", True)),
            use_corrector=len(cfg.get("disable_corrector", [])) == 0,
        )
    if name in ("DPMSolverMultistepScheduler", "FlowDPMSolverMultistepScheduler"):
        return DPMSolverFlowScheduler(
            **common,
            solver_order=int(cfg.get("solver_order", 2)),
            lower_order_final=bool(cfg.get("lower_order_final", True)),
        )
    if name == "FlowMatchEulerDiscreteScheduler":
        return FlowMatchEulerScheduler(**common)
    if name in ("CogVideoXDDIMScheduler", "DDIMScheduler"):
        if not isinstance(default, CogVideoXDDIMScheduler):
            return default  # a flow-matching family has no DDIM sampler
        return CogVideoXDDIMScheduler(
            num_train_timesteps=common["num_train_timesteps"],
            beta_start=float(cfg.get("beta_start", 0.00085)),
            beta_end=float(cfg.get("beta_end", 0.012)),
            snr_shift_scale=float(cfg.get("snr_shift_scale", 3.0)),
            rescale_betas_zero_snr=bool(cfg.get("rescale_betas_zero_snr", True)),
        )
    return default
