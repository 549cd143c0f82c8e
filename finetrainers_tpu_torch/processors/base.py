"""Processor contract (copied from `finetrainers_tpu/processors/base.py:11-33`):
introspects `forward`'s signature, renames inputs via `input_names`, filters
kwargs, drops outputs named `__drop__`."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional


DROP_KEY = "__drop__"


class ProcessorMixin:
    output_names: List[str] = []
    input_names: Optional[Dict[str, str]] = None

    def __call__(self, **kwargs) -> Dict[str, Any]:
        if self.input_names is not None:
            for old, new in self.input_names.items():
                if old in kwargs:
                    kwargs[new] = kwargs.pop(old)
        params = inspect.signature(self.forward).parameters
        accepts_kwargs = any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())
        if not accepts_kwargs:
            kwargs = {k: v for k, v in kwargs.items() if k in params}
        output = self.forward(**kwargs)
        return {k: v for k, v in output.items() if k != DROP_KEY}

    def forward(self, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError
