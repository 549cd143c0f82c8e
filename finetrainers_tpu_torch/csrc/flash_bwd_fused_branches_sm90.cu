// K5's causal, segment and mask branches, built as a library of their own so
// that nvcc compiles them beside K2, K3, K5 and K2's and K3's branches
// (`ops/_build.py` starts one nvcc per source at once): the kernel is
// flash_bwd_sm90.cu's, the entry point K5's branches' (its
// FLASH_BWD_FUSED_BRANCHES section).
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_bwd_fused_kernel's
// causal (:1137-1141, skip :1169-1172), segment (:1142-1144) and mask
// (:1145-1146, skip :1173-1175) selects (Pallas, TPU).

#define FLASH_BWD_FUSED_BRANCHES
#include "flash_bwd_sm90.cu"
