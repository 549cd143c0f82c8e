"""Train-state bookkeeping (port of the fields of `finetrainers_tpu/state.py`
that the train loop records, with their checkpoint round trip)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class TrainState:
    step: int = 0
    observed_data_samples: int = 0
    global_avg_losses: List[float] = dataclasses.field(default_factory=list)
    global_max_losses: List[float] = dataclasses.field(default_factory=list)
    log_steps: List[int] = dataclasses.field(default_factory=list)

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for key, value in state_dict.items():
            if hasattr(self, key):
                setattr(self, key, value)


@dataclasses.dataclass
class State:
    train_state: TrainState = dataclasses.field(default_factory=TrainState)
    num_trainable_parameters: int = 0
    generator_seed: Optional[int] = None
