"""Activation checkpointing (port of `finetrainers_tpu/utils/activation_checkpoint.py`).

Per-block `torch.utils.checkpoint` (non-reentrant) in place of the JAX
package's `jax.checkpoint` policies:

  - "full":       save nothing inside a block; recompute it in the backward.
  - "block_skip": "full" on every second block only (`should_checkpoint_block`).
  - "ops", "ops_attn", "ops_narrow": selective policies that save matmul and
    attention outputs. They need selective checkpointing that sees the flash
    kernel as one op, and raise NotImplementedError until then (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable

import torch.utils.checkpoint

CHECKPOINT_TYPES = ("full", "ops", "ops_attn", "ops_narrow", "block_skip")
_SELECTIVE = ("ops", "ops_attn", "ops_narrow")


def should_checkpoint_block(block_index: int, checkpoint_type: str = "full", skip_every: int = 2) -> bool:
    """block_skip: remat alternate blocks only (reference block_skip semantics)."""
    if checkpoint_type == "block_skip":
        return block_index % skip_every == 0
    return True


def apply_activation_checkpointing(forward_fn: Callable, checkpoint_type: str = "full") -> Callable:
    """Wrap a forward function so its activations are recomputed in the backward."""
    if checkpoint_type in _SELECTIVE:
        raise NotImplementedError(
            f"checkpoint type {checkpoint_type!r} needs selective checkpointing that sees the flash kernel "
            "as one op; not ported yet, see ROADMAP.md queue 1 (remat policies)"
        )
    if checkpoint_type not in CHECKPOINT_TYPES:
        raise ValueError(f"Unknown checkpoint type {checkpoint_type!r}; choose from {CHECKPOINT_TYPES}")

    def checkpointed(*args):
        return torch.utils.checkpoint.checkpoint(forward_fn, *args, use_reentrant=False)

    return checkpointed
