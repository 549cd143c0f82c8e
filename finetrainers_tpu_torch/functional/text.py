"""Caption string ops (subset of `finetrainers_tpu/functional/text.py`)."""

from __future__ import annotations

import random
from typing import List, Union


def dropout_caption(caption: Union[str, List[str]], dropout_p: float = 0) -> Union[str, List[str]]:
    """Copied from `finetrainers_tpu/functional/text.py:23-28`."""
    if random.random() >= dropout_p:
        return caption
    if isinstance(caption, str):
        return ""
    return [""] * len(caption)
