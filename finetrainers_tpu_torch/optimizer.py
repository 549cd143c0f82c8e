"""Optimizers and LR schedules (port of `finetrainers_tpu/optimizer.py`).

The JAX package builds optax chains; this port keeps their arithmetic:
  - `get_lr_scheduler` returns step -> learning rate for the seven schedules,
    with optax's semantics (e.g. `join_schedules`, `piecewise_constant_schedule`).
  - `get_optimizer` returns a `ClippedOptimizer`: optax's
    `clip_by_global_norm` (scale by max_norm / norm only when norm >= max_norm,
    with no epsilon) followed by adam or adamw. The update runs in
    `torch.optim.Adam` / `AdamW`, whose arithmetic is optax's: bias-corrected
    moments, eps added to the square root of the corrected second moment, and
    in adamw a weight decay decoupled from the gradient. As in optax, the
    learning rate of an update is the schedule at the number of updates made
    before it.
  - `adam-bnb-8bit` / `adamw-bnb-8bit` keep the moments as int8 codes
    (`optim8bit.py`) under the same clip and schedule.
  - `MultiSteps` is `optax.MultiSteps` over it (gradient accumulation, the
    JAX trainer's `--gradient_accumulation_steps`): each `step` is one
    micro-step whose gradients join a running mean; the k-th clips, updates
    and advances the schedule's count, the others change no parameter.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

SUPPORTED_OPTIMIZERS = ["adam", "adamw", "adam-bnb-8bit", "adamw-bnb-8bit"]
SUPPORTED_SCHEDULERS = [
    "constant",
    "constant_with_warmup",
    "piecewise_constant",
    "linear",
    "cosine",
    "cosine_with_restarts",
    "polynomial",
]

Schedule = Callable[[int], float]


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule."""
    return lambda step: init + (end - init) * min(max(step, 0), transition_steps) / transition_steps


def get_lr_scheduler(
    name: str,
    lr: float,
    warmup_steps: int = 0,
    train_steps: int = 1000,
    num_cycles: int = 1,
    power: float = 1.0,
    step_rules: Optional[str] = None,
) -> Schedule:
    """Return a schedule mapping step -> learning rate."""
    name = name or "constant"

    if name == "constant":
        return lambda step: lr

    if name == "constant_with_warmup":
        warm = _linear(0.0, 1.0, max(warmup_steps, 1))
        return lambda step: lr * (warm(step) if warmup_steps > 0 else 1.0)

    if name == "piecewise_constant":
        # diffusers' step_rules: "1:10,0.1:20,0.01" => multiplier 1 until step
        # 10, 0.1 until step 20, then 0.01.
        if step_rules is None:
            raise ValueError("piecewise_constant scheduler requires step_rules")
        rules = step_rules.split(",")
        mults = [float(rule.split(":")[0]) for rule in rules]
        boundaries = [int(rule.split(":")[1]) for rule in rules[:-1]]
        scales = [nxt / cur for cur, nxt in zip(mults, mults[1:])]

        def piecewise(step):
            value = lr * mults[0]
            for boundary, scale in zip(boundaries, scales):
                if step >= boundary:
                    value *= scale
            return value

        return piecewise

    if name == "linear":
        up = _linear(0.0, lr, max(warmup_steps, 1))
        down = _linear(lr, 0.0, max(train_steps - warmup_steps, 1))
        return lambda step: up(step) if step < warmup_steps else down(step - warmup_steps)

    def warm(step):
        return min(step / max(warmup_steps, 1), 1.0)

    def progress(step):
        return min(max((step - warmup_steps) / max(train_steps - warmup_steps, 1), 0.0), 1.0)

    if name == "cosine":
        def cosine(step):
            cos = 0.5 * (1.0 + math.cos(math.pi * float(num_cycles) * 2.0 * progress(step)))
            return lr * (warm(step) if step < warmup_steps else max(0.0, cos))

        return cosine

    if name == "cosine_with_restarts":
        def cosine_with_restarts(step):
            p = progress(step)
            cos = 0.5 * (1.0 + math.cos(math.pi * ((float(num_cycles) * p) % 1.0)))
            return lr * (warm(step) if step < warmup_steps else (0.0 if p >= 1.0 else max(0.0, cos)))

        return cosine_with_restarts

    if name == "polynomial":
        lr_end = 1e-7

        def polynomial(step):
            if step < warmup_steps:
                return lr * warm(step)
            pct = 1.0 - min(max(step - warmup_steps, 0.0) / max(train_steps - warmup_steps, 1), 1.0)
            return (lr - lr_end) * pct**power + lr_end

        return polynomial

    raise ValueError(f"Unsupported scheduler {name}; choose from {SUPPORTED_SCHEDULERS}")


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all gradients together (a device scalar)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class ClippedOptimizer:
    """[clip_by_global_norm] -> adam(w) over a list of parameters, with the
    learning rate from a schedule (the optax chain `get_optimizer` builds)."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule, max_grad_norm: Optional[float]) -> None:
        self.inner = inner
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm if max_grad_norm is not None and max_grad_norm > 0 else None
        self.count = 0  # updates made so far (optax's count)
        self.params = [p for group in inner.param_groups for p in group["params"]]

    def step(self) -> torch.Tensor:
        """Clip the gradients by their global norm, update, and return the
        norm before clipping (a device scalar; nothing here waits for the device)."""
        for param in self.params:
            if param.grad is None:  # optax's gradient tree holds zeros there: the moments and the decay still apply
                param.grad = torch.zeros_like(param)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.max_grad_norm is not None:
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, Any]:
        """The moments, their step and the schedule's count."""
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        self.count = state_dict["count"]


class MultiSteps:
    """`optax.MultiSteps(optimizer, every_k)` with its default gradient mean.

    `step` takes the micro-batch's gradients from `.grad`: they join the
    running mean acc + (g - acc) / (n + 1) of the n micro-steps before (a
    parameter without a gradient adds zeros). On the k-th micro-step the mean
    goes to the wrapped optimizer (clip, update, the schedule's count) and the
    accumulator restarts at zero; on the others no parameter changes."""

    def __init__(self, inner: ClippedOptimizer, every_k: int) -> None:
        self.inner = inner
        self.every_k = every_k
        self.params = inner.params
        self.mini_step = 0
        self.acc_grads = [torch.zeros_like(p) for p in self.params]

    @property
    def count(self) -> int:
        """Updates applied so far (the wrapped optimizer's count)."""
        return self.inner.count

    def step(self) -> torch.Tensor:
        """One micro-step; returns the micro-batch's gradient norm (a device scalar)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = global_norm(grads)
        torch._foreach_add_(self.acc_grads,
                            torch._foreach_div(torch._foreach_sub(grads, self.acc_grads), self.mini_step + 1))
        if self.mini_step == self.every_k - 1:
            for param, acc in zip(self.params, self.acc_grads):
                param.grad = acc
            self.inner.step()
            self.acc_grads = [torch.zeros_like(p) for p in self.params]
            self.mini_step = 0
        else:
            self.mini_step += 1
        return norm

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def state_dict(self) -> Dict[str, Any]:
        """The wrapped optimizer's state, the micro-step count and the running mean."""
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step, "acc_grads": self.acc_grads}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        self.mini_step = state_dict["mini_step"]
        for acc, saved in zip(self.acc_grads, state_dict["acc_grads"]):
            acc.copy_(saved)


def get_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    learning_rate: Union[float, Schedule],
    beta1: float = 0.9,
    beta2: float = 0.95,
    epsilon: float = 1e-8,
    weight_decay: float = 1e-4,
    max_grad_norm: Optional[float] = None,
    quant_dims: Optional[List[int]] = None,
) -> ClippedOptimizer:
    """Build [clip_by_global_norm] -> adam(w) over `params`; the 8-bit ones
    quantize each parameter's moments over its entry of `quant_dims`
    (`optim8bit.jax_row_dims`; -1 for all by default)."""
    name = (name or "adamw").lower()
    params = list(params)
    schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    lr0 = schedule(0)
    if name == "adam":
        inner = torch.optim.Adam(params, lr=lr0, betas=(beta1, beta2), eps=epsilon, weight_decay=0.0)
    elif name == "adamw":
        inner = torch.optim.AdamW(params, lr=lr0, betas=(beta1, beta2), eps=epsilon, weight_decay=weight_decay)
    elif name == "adam-bnb-8bit":
        from .optim8bit import adam_8bit

        inner = adam_8bit(params, lr0, b1=beta1, b2=beta2, eps=epsilon, quant_dims=quant_dims)
    elif name == "adamw-bnb-8bit":
        from .optim8bit import adamw_8bit

        inner = adamw_8bit(params, lr0, b1=beta1, b2=beta2, eps=epsilon, weight_decay=weight_decay,
                           quant_dims=quant_dims)
    else:
        raise ValueError(f"Unsupported optimizer {name}; choose from {SUPPORTED_OPTIMIZERS}")
    return ClippedOptimizer(inner, schedule, max_grad_norm)
