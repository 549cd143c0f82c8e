"""finetrainers_tpu_torch: the PyTorch/CUDA port of finetrainers_tpu for the
NVIDIA H100. The JAX package `finetrainers_tpu` is the reference it is held
against; this package never imports it or JAX. Kernels are built on first use,
never at import.
"""

from .config import ModelType, TrainingType, get_model_specification_cls
from .logging import get_logger
from .models import ModelSpecification


__version__ = "0.1.0"
