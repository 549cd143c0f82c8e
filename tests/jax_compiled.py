"""`compiled(fn, *args)`: a JAX reference jitted and compiled at XLA's lowest
optimization level, then called once.

The port's parity tests call the JAX Pallas kernels in interpret mode. Called
eagerly, each grid step is dispatched op by op (seconds a call); jitted with
XLA's default passes, the compile takes most of the time. At the lowest level
the compile is about three times faster and the arithmetic the same: the
passes left out fuse and schedule, they do not reassociate fp32 sums. A switch
the JAX package reads when it traces (FINETRAINERS_FLASH_*) must be set
before the call: the call traces.
"""

import jax

_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """fn(*args), traced, compiled with _OPTIONS and run."""
    return jax.jit(fn).lower(*args).compile(_OPTIONS)(*args)
