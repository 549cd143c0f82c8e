"""Activation checkpointing (port of `finetrainers_tpu/utils/activation_checkpoint.py`).

Per-block non-reentrant `torch.utils.checkpoint` in place of the JAX
package's `jax.checkpoint` policies:

  - "full":       save nothing inside a block; recompute it in the backward.
  - "block_skip": "full" on every second block only (`should_checkpoint_block`).
  - "ops":        save the flash attention op K4 (`finetrainers_torch::flash_mha`,
                  the JAX "attn_out" tag) and every matrix product without a
                  batch dimension (`aten.mm`, `aten.addmm`: the projections and
                  the MLP, JAX's `dots_with_no_batch_dims_saveable`); recompute
                  the rest (norms, modulation, activations, `bmm`).
  - "ops_attn":   save only K4's outputs; recompute every product.
  - "ops_narrow": as "ops", but a product whose output's last dimension is
                  over 4096 (the MLP's hidden layer) is recomputed.

The selective policies run through `create_selective_checkpoint_contexts`,
which decides per op at the dispatcher: K4's forward goes through the
dispatcher op `finetrainers_torch::flash_mha` while a dispatch mode is active
(a kernel launched through ctypes would be invisible to it). The JAX
policies also save the name "norm_stat", which nothing in the JAX package
emits, so nothing is ported for it. A non-flash provider's attention output
(`_native_math`) is not saved whole as JAX's `checkpoint_name` saves it: its
`bmm`s are recomputed.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..ops import flash_attention as _flash_attention  # noqa: F401  (defines finetrainers_torch::flash_mha)

CHECKPOINT_TYPES = ("full", "ops", "ops_attn", "ops_narrow", "block_skip")
NARROW_MAX_DIM = 4096  # "ops_narrow": products with a wider output are recomputed (JAX :63-77)


def _product_out_dim(op, args) -> Optional[int]:
    """The output's last dimension of a matrix product without batch
    dimensions (`mm(a, b)`, `addmm(c, a, b)`), else None."""
    if op is torch.ops.aten.mm.default:
        return args[1].shape[-1]
    if op is torch.ops.aten.addmm.default:
        return args[2].shape[-1]
    return None


def _policy(checkpoint_type: str) -> Callable:
    """The per-op policy of a selective checkpoint type."""
    save_products = checkpoint_type in ("ops", "ops_narrow")
    max_dim = NARROW_MAX_DIM if checkpoint_type == "ops_narrow" else None
    flash = torch.ops.finetrainers_torch.flash_mha.default

    def policy(ctx, op, *args, **kwargs):
        if op is flash:
            return CheckpointPolicy.MUST_SAVE
        if save_products:
            out_dim = _product_out_dim(op, args)
            if out_dim is not None and (max_dim is None or out_dim <= max_dim):
                return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def should_checkpoint_block(block_index: int, checkpoint_type: str = "full", skip_every: int = 2) -> bool:
    """block_skip: remat alternate blocks only (reference block_skip semantics)."""
    if checkpoint_type == "block_skip":
        return block_index % skip_every == 0
    return True


def apply_activation_checkpointing(forward_fn: Callable, checkpoint_type: str = "full") -> Callable:
    """Wrap a forward function so its activations are recomputed in the
    backward, all of them ("full", "block_skip") or those the selective
    policy does not save ("ops", "ops_attn", "ops_narrow")."""
    if checkpoint_type not in CHECKPOINT_TYPES:
        raise ValueError(f"Unknown checkpoint type {checkpoint_type!r}; choose from {CHECKPOINT_TYPES}")
    if checkpoint_type in ("full", "block_skip"):
        def checkpointed(*args):
            return checkpoint(forward_fn, *args, use_reentrant=False)
    else:
        policy = _policy(checkpoint_type)

        def checkpointed(*args):
            return checkpoint(forward_fn, *args, use_reentrant=False,
                              context_fn=lambda: create_selective_checkpoint_contexts(policy))

    return checkpointed
