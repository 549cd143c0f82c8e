// The branches of K7c (causal, segment ids, a dense mask) and the segment
// branches of K7a and K7b, built as a library of their own so that nvcc
// compiles them beside K1, K7a/b/c and K1's branches (`ops/_build.py` starts
// one nvcc per source at once): the kernels are flash_fwd_sm90.cu's, the entry
// point the variants' branches' (its FLASH_FWD_VARIANT_BRANCHES section).
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_fwd_kernel's causal,
// segment and mask selects (:201-222, skips :299-313) under its `two_level`
// step (:229-246, :266-285), ::_fwd_kernel_twopass's segment select (:438-442)
// and ::_fwd_kernel_skew's (:629-633) (Pallas, TPU).

#define FLASH_FWD_VARIANT_BRANCHES
#include "flash_fwd_sm90.cu"
