"""Caption string ops (copied from `finetrainers_tpu/functional/text.py`, the
functions that take no arrays)."""

from __future__ import annotations

import random
from typing import List, Sequence, Union


def convert_byte_str_to_str(s: str, encoding: str = "utf-8") -> str:
    """The string inside a stringified bytes literal, e.g. "b'hi'" -> "hi";
    plain strings pass through untouched."""
    if not (len(s) >= 3 and s[0] == "b" and s[1] in ("'", '"') and s[-1] == s[1]):
        return s
    try:
        return s[2:-1].encode("utf-8").decode(encoding)
    except (UnicodeDecodeError, UnicodeEncodeError, IndexError):
        return s


def dropout_caption(caption: Union[str, List[str]], dropout_p: float = 0) -> Union[str, List[str]]:
    if random.random() >= dropout_p:
        return caption
    if isinstance(caption, str):
        return ""
    return [""] * len(caption)


def remove_prefix(text: str, prefixes: Sequence[str]) -> str:
    """`text` without the first of `prefixes` it starts with, stripped."""
    for prefix in prefixes:
        if text.startswith(prefix):
            return text.removeprefix(prefix).strip()
    return text
