"""Training checkpoints on one card (port of `finetrainers_tpu/parallel/checkpoint.py`).

Step directories `finetrainers_step_<step>` under the output directory, each
holding one `state.pt` written by `torch.save` and read by `torch.load`
(`weights_only=True`): the JAX package's orbax manager shards its writes over
a mesh, which one card does not need, and the two formats are not
interchangeable. A save happens every `checkpointing_steps` steps or when
forced; after it, the oldest step directories beyond `checkpointing_limit`
are removed and the callback (the trainer's export) runs. Saving a step
first removes the steps after it: they were left by a run whose history this
one does not continue (a fresh run in a used directory, or a resume from an
earlier step), and "latest" must name this run's newest state. The state
file is written under a temporary name and renamed, so a step directory
without `state.pt` is never taken for a checkpoint.
"""

from __future__ import annotations

import os
import pathlib
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .logging import get_logger

logger = get_logger(__name__)

CHECKPOINT_PREFIX = "finetrainers_step_"
STATE_FILE = "state.pt"


class Checkpointer:
    def __init__(
        self,
        output_dir: str,
        checkpointing_steps: int = 500,
        checkpointing_limit: Optional[int] = None,
        callback_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        self.output_dir = pathlib.Path(output_dir).absolute()
        self.checkpointing_steps = checkpointing_steps
        self.checkpointing_limit = checkpointing_limit
        self._callback_fn = callback_fn

    def step_dir(self, step: int) -> pathlib.Path:
        return self.output_dir / f"{CHECKPOINT_PREFIX}{step}"

    def save(self, step: int, state: Dict[str, Any], force: bool = False) -> bool:
        """Save `state` (tensors, numbers, strings and containers of them) as
        step `step` if the cadence or `force` asks for it; returns whether it did."""
        if not force and (self.checkpointing_steps <= 0 or step % self.checkpointing_steps != 0):
            return False
        for later in [s for s in self.all_steps() if s > step]:
            logger.warning(f"Removing checkpoint step {later}: it is not on the history of the run saving step {step}")
            shutil.rmtree(self.step_dir(later))
        directory = self.step_dir(step)
        directory.mkdir(parents=True, exist_ok=True)
        tmp = directory / (STATE_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, directory / STATE_FILE)
        if self.checkpointing_limit is not None and self.checkpointing_limit > 0:
            for old in self.all_steps()[:-self.checkpointing_limit]:
                shutil.rmtree(self.step_dir(old))
        if self._callback_fn is not None:
            self._callback_fn(state)
        logger.info(f"Saved checkpoint at step {step} to {directory}")
        return True

    def all_steps(self) -> List[int]:
        """The steps saved in full, in increasing order."""
        steps = []
        for path in self.output_dir.glob(f"{CHECKPOINT_PREFIX}*"):
            suffix = path.name[len(CHECKPOINT_PREFIX):]
            if suffix.isdigit() and (path / STATE_FILE).is_file():
                steps.append(int(suffix))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: int = -1) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(step, state) with every tensor on the CPU, or None if that step
        (step=-1: the latest) was not saved."""
        if step == -1:
            step = self.latest_step()
        if step is None or step not in self.all_steps():
            return None
        state = torch.load(self.step_dir(step) / STATE_FILE, map_location="cpu", weights_only=True)
        logger.info(f"Restored checkpoint from step {step}")
        return step, state
