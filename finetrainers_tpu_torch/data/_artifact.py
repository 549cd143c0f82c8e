"""Validation artifacts (copied from `finetrainers_tpu/data/_artifact.py`)."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Artifact:
    type: str = "unknown"
    value: Any = None
    file_extension: str = "bin"
    caption: Any = None  # prompt the sample was generated from


@dataclasses.dataclass
class ImageArtifact(Artifact):
    type: str = "image"
    file_extension: str = "png"


@dataclasses.dataclass
class VideoArtifact(Artifact):
    type: str = "video"
    file_extension: str = "mp4"
