"""8-bit Adam moments (port of `finetrainers_tpu/optim8bit.py`, the
`adam-bnb-8bit` / `adamw-bnb-8bit` optimizers).

The moments of a parameter of at least 4096 elements are stored as
int8 codes with one fp32 absmax scale per row (1 byte a parameter instead of
4); smaller parameters keep fp32 moments, as bitsandbytes'
`min_8bit_size=4096` does. The first moment m takes signed absmax codes; the
second moment v is stored as sqrt(v), whose codes then carry a relative
error in the square root. The update is JAX's `scale_by_adam_8bit` step by
step in fp32 (:78-97): dequantize, move the moments, correct their bias,
take m_hat / (sqrt(v_hat) + eps), quantize them again; adamw then adds the
decoupled decay weight_decay * p and the learning rate scales the sum.
Plain torch ops inside the update: the JAX package runs it as XLA ops too,
not as a Pallas kernel.

A row here is JAX's row: the absmax runs over the last axis of the JAX
layout, which for a linear layer's weight (and a LoRA factor) is the port's
first dim (its (out, in) is JAX's (in, out) transposed), so `get_optimizer`
hands the quantized dim of each parameter over (`quant_dims`), and the
codes equal JAX's at the transposed position. The threshold is read from
FINETRAINERS_8BIT_MIN_SIZE (default 4096) when an optimizer is built, as JAX
reads it.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

def quantize(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed absmax codes over `dim` (`_quantize`, :41-45): (int8 codes, fp32
    scales with `dim` kept as 1)."""
    scales = x.abs().amax(dim=dim, keepdim=True)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.round(x / safe * 127.0).clamp(-127, 127).to(torch.int8)
    return codes, scales.float()


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """`_dequantize` (:48-49), scales / 127 a true division on every device
    (`ops.int8_linear.absmax_scale`'s reason)."""
    return codes.float() * (scales / torch.full_like(scales, 127.0))


class Adam8bit(torch.optim.Optimizer):
    """Adam(W) with 8-bit moments. `quant_dims[i]` is the dim of the i-th
    parameter over which its rows' absmax runs (-1 by default). With
    `decoupled`, adamw's decay: p -= lr * (step + weight_decay * p)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, decoupled: bool = False,
                 quant_dims: Optional[Sequence[int]] = None) -> None:
        params = list(params)
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.decoupled = decoupled
        self.min_8bit_size = int(os.environ.get("FINETRAINERS_8BIT_MIN_SIZE", "4096"))
        dims = list(quant_dims) if quant_dims is not None else [-1] * len(params)
        self._dims = {id(p): d for p, d in zip(params, dims)}

    def quant_dim(self, p: torch.nn.Parameter) -> int:
        return self._dims.get(id(p), -1)

    def is_8bit(self, p: torch.nn.Parameter) -> bool:
        """`_big` (:69-70): at least min_8bit_size elements and rows of at least 2."""
        return p.numel() >= self.min_8bit_size and p.ndim >= 1 and p.shape[self.quant_dim(p)] >= 2

    def _init_state(self, p: torch.nn.Parameter) -> dict:
        zeros = torch.zeros_like(p, dtype=torch.float32)
        state = {"step": torch.zeros((), dtype=torch.float32, device=p.device)}
        if self.is_8bit(p):
            codes, scales = quantize(zeros, self.quant_dim(p))
            state.update(mu_codes=codes, mu_scales=scales, nu_codes=codes.clone(), nu_scales=scales.clone())
        else:
            state.update(mu=zeros, nu=zeros.clone())
        return state

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                state["step"] += 1
                count = state["step"]
                g = p.grad.float()
                quantized = "mu_codes" in state
                if quantized:
                    mu = dequantize(state["mu_codes"], state["mu_scales"])
                    nu = dequantize(state["nu_codes"], state["nu_scales"]) ** 2
                else:
                    mu, nu = state["mu"], state["nu"]
                mu = b1 * mu + (1.0 - b1) * g
                nu = b2 * nu + (1.0 - b2) * (g * g)
                mu_hat = mu / (1.0 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** count)
                nu_hat = nu / (1.0 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** count)
                update = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                if quantized:
                    dim = self.quant_dim(p)
                    state["mu_codes"], state["mu_scales"] = quantize(mu, dim)
                    state["nu_codes"], state["nu_scales"] = quantize(torch.sqrt(nu), dim)
                else:
                    state["mu"], state["nu"] = mu, nu
                if self.decoupled and group["weight_decay"]:
                    update = update + group["weight_decay"] * p.float()
                p.add_((-group["lr"] * update).to(p.dtype))
        return None

    def state_bytes(self) -> int:
        """Bytes the moments hold: codes, scales and fp32 moments."""
        return sum(t.numel() * t.element_size() for st in self.state.values() for k, t in st.items() if k != "step")


def jax_row_dims(module: torch.nn.Module, names: Iterable[str]) -> List[int]:
    """The quantized dim of each named parameter of `module`: 0 for the 2D
    weight of a linear layer or a LoRA factor (JAX's (in, out) kernel is its
    transpose, so JAX's last axis is its first dim), -1 for the rest."""
    from .models.layers import LoRADense, LoRAFactor

    linear = {f"{name}.weight" for name, m in module.named_modules() if isinstance(m, (LoRADense, LoRAFactor))}
    params = dict(module.named_parameters())
    return [0 if name in linear and params[name].ndim == 2 else -1 for name in names]


def adam_8bit(params: List[torch.nn.Parameter], lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              quant_dims: Optional[Sequence[int]] = None) -> Adam8bit:
    """`adam_8bit` (:106-115)."""
    return Adam8bit(params, lr=lr, betas=(b1, b2), eps=eps, quant_dims=quant_dims)


def adamw_8bit(params: List[torch.nn.Parameter], lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 1e-4, quant_dims: Optional[Sequence[int]] = None) -> Adam8bit:
    """`adamw_8bit` (:118-130)."""
    return Adam8bit(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay, decoupled=True,
                    quant_dims=quant_dims)
