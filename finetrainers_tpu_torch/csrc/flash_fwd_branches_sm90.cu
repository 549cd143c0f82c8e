// K1's dense-mask, causal and segment branches, built as a library of their
// own so that nvcc compiles them beside K1 and K7a/b/c (`ops/_build.py` starts
// one nvcc per source at once): the kernels are flash_fwd_sm90.cu's, the entry
// points the branches' (its FLASH_FWD_BRANCHES section).
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_fwd_kernel's `mask_ref`
// (:217-222, skip :304-307), causal (:205-209, skip :300-303) and segment
// (:210-214) branches (Pallas, TPU).

#define FLASH_FWD_BRANCHES
#include "flash_fwd_sm90.cu"
