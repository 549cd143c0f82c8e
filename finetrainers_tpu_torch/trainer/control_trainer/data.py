"""Control data (port of `finetrainers_tpu/trainer/control_trainer/data.py`):

- `IterableControlDataset` adds a control signal to each sample: the Canny
  edges of its image or video (`--control_type canny`), or the media itself
  (`custom`), where the sample has no paired `control_image`/`control_video`
  column; `none` adds nothing, so the control must come from such a column
  (:18-56). Everything else, the loader's `state_dict` above all, is the
  wrapped dataset's, so a resume restores the same position.
- `apply_frame_conditioning_on_latents`, the host (numpy) form (:59-114).
- `apply_frame_conditioning_on_latents_torch`, the form the Wan control
  forward runs (JAX's traced form, :117-149): `prefix` and `random` take
  their draws handed in ("frame_keep", and for `random` "frame_scores"),
  else from a `torch.Generator`.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ...processors import CannyProcessor, CopyProcessor
from .config import ControlType, FrameConditioningType


class IterableControlDataset:
    """Wraps the preprocessed dataset, adding control_image / control_video."""

    def __init__(self, dataset, control_type: str = ControlType.CANNY.value) -> None:
        self.dataset = dataset
        self.control_type = ControlType(control_type).value
        self._canny = CannyProcessor(["control"])
        self._copy = CopyProcessor(["control"])

    def __getattr__(self, name: str):
        # state_dict, load_state_dict, _precomputable_once, ...: the wrapped dataset's, where it has them.
        if name == "dataset":
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for sample in self.dataset:
            yield self._process(sample)

    def _process(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(sample)
        if self.control_type == ControlType.NONE.value:
            return out
        processor = self._canny if self.control_type == ControlType.CANNY.value else self._copy
        if "image" in out and "control_image" not in out:
            out["control_image"] = processor(input=out["image"])["control"]
        if "video" in out and "control_video" not in out:
            out["control_video"] = processor(input=out["video"])["control"]
        return out


def apply_frame_conditioning_on_latents(
    latents: np.ndarray,
    expected_num_frames: int,
    channel_dim: int,
    frame_dim: int,
    frame_conditioning_type: str,
    frame_conditioning_index: Optional[int] = None,
    concatenate_mask: bool = False,
) -> np.ndarray:
    """Host-side masking of control latents per conditioning type, cut or
    zero-padded to `expected_num_frames` (copied from JAX :59-114; `prefix`
    and `random` draw from Python's `random`)."""
    num_frames = latents.shape[frame_dim]
    mask = np.zeros_like(latents)

    def frame_slice(idx):
        s = [slice(None)] * latents.ndim
        s[frame_dim] = idx
        return tuple(s)

    ftype = FrameConditioningType(frame_conditioning_type)
    if ftype == FrameConditioningType.INDEX:
        mask[frame_slice(min(frame_conditioning_index or 0, num_frames - 1))] = 1
        latents = latents * mask
    elif ftype == FrameConditioningType.PREFIX:
        keep = random.randint(1, num_frames)
        mask[frame_slice(slice(0, keep))] = 1
        latents = latents * mask
    elif ftype == FrameConditioningType.RANDOM:
        keep = random.randint(1, num_frames)
        idx = random.sample(range(num_frames), keep)
        mask[frame_slice(idx)] = 1
        latents = latents * mask
    elif ftype == FrameConditioningType.FIRST_AND_LAST:
        mask[frame_slice(0)] = 1
        mask[frame_slice(num_frames - 1)] = 1
        latents = latents * mask
    elif ftype == FrameConditioningType.FULL:
        mask[frame_slice(slice(0, num_frames))] = 1

    if num_frames >= expected_num_frames:
        latents = latents[frame_slice(slice(0, expected_num_frames))]
        mask = mask[frame_slice(slice(0, expected_num_frames))]
    else:
        pad_shape = list(latents.shape)
        pad_shape[frame_dim] = expected_num_frames - num_frames
        pad = np.zeros(pad_shape, latents.dtype)
        latents = np.concatenate([latents, pad], axis=frame_dim)
        mask = np.concatenate([mask, pad], axis=frame_dim)

    if concatenate_mask:
        latents = np.concatenate([latents, mask], axis=channel_dim)
    return latents


def apply_frame_conditioning_on_latents_torch(
    latents: torch.Tensor,
    frame_dim: int,
    channel_dim: int,
    frame_conditioning_type: str,
    frame_conditioning_index: int = 0,
    concatenate_mask: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Mask the control latents' frames by type (JAX :117-149): `index` keeps
    frame `frame_conditioning_index` (the last where past the end), `prefix`
    the first `frame_keep` frames, `random` the `frame_keep` frames of the
    lowest `frame_scores`, `first_and_last` those two, `full` all. The
    number kept is uniform on [1, frames] and the scores uniform on [0, 1),
    from `draws` where given, else from `generator`. With `concatenate_mask`
    the 0/1 mask joins the latents on the channel axis."""
    draws = draws or {}
    num_frames = latents.shape[frame_dim]
    device = latents.device
    shape = [1] * latents.ndim
    shape[frame_dim] = num_frames
    frame_idx = torch.arange(num_frames, device=device).reshape(shape)

    def keep():
        value = draws.get("frame_keep")
        if value is None:
            return int(torch.randint(1, num_frames + 1, (), generator=generator, device=device))
        return int(value)

    ftype = FrameConditioningType(frame_conditioning_type)
    if ftype == FrameConditioningType.INDEX:
        frame_mask = frame_idx == min(frame_conditioning_index, num_frames - 1)
    elif ftype == FrameConditioningType.PREFIX:
        frame_mask = frame_idx < keep()
    elif ftype == FrameConditioningType.RANDOM:
        n_keep = keep()
        scores = draws.get("frame_scores")
        scores = (torch.rand((num_frames,), generator=generator, device=device) if scores is None
                  else torch.as_tensor(np.array(scores, np.float32), device=device))
        ranks = torch.argsort(torch.argsort(scores))
        frame_mask = (ranks < n_keep).reshape(shape)
    elif ftype == FrameConditioningType.FIRST_AND_LAST:
        frame_mask = (frame_idx == 0) | (frame_idx == num_frames - 1)
    else:  # FULL
        frame_mask = torch.ones_like(frame_idx, dtype=torch.bool)

    mask = frame_mask.expand(latents.shape).to(latents.dtype)
    if ftype != FrameConditioningType.FULL:
        latents = latents * mask
    if concatenate_mask:
        latents = torch.cat([latents, mask], dim=channel_dim)
    return latents
