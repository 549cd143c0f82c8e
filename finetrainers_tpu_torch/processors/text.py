"""Caption dropout processor (copied from `finetrainers_tpu/processors/text.py:11-17`)."""

from __future__ import annotations

from typing import Any, Dict

from ..functional.text import dropout_caption
from .base import ProcessorMixin


class CaptionTextDropoutProcessor(ProcessorMixin):
    def __init__(self, dropout_p: float = 0.0):
        self.dropout_p = dropout_p
        self.output_names = ["caption"]

    def forward(self, caption, **kwargs) -> Dict[str, Any]:
        return {"caption": dropout_caption(caption, self.dropout_p)}
