"""Logging (port of `get_logger` from `finetrainers_tpu/logging.py`): one stream
handler per named logger, level from FINETRAINERS_LOG_LEVEL."""

from __future__ import annotations

import logging
import os

from .constants import FINETRAINERS_LOG_LEVEL


_FORMAT = "%(asctime)s [%(levelname)s] p%(process)d %(name)s: %(message)s"


def get_logger(name: str = "finetrainers_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("FINETRAINERS_LOG_LEVEL", FINETRAINERS_LOG_LEVEL))
        logger.propagate = False
    return logger
