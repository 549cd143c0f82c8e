"""Environment knobs of the port (subset of `finetrainers_tpu/constants.py`)."""

import os


FINETRAINERS_LOG_LEVEL = os.environ.get("FINETRAINERS_LOG_LEVEL", "INFO")
# "auto": the hand-written flash kernel (K1) where it applies, plain math otherwise.
FINETRAINERS_ATTN_PROVIDER = os.environ.get("FINETRAINERS_ATTN_PROVIDER", "auto")
FINETRAINERS_ATTN_CHECKS = os.environ.get("FINETRAINERS_ATTN_CHECKS", "0") in ("1", "true", "TRUE", "True")
