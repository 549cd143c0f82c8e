// K2's and K3's causal, segment and mask branches, built as a library of their
// own so that nvcc compiles them beside K2, K3 and K5 (`ops/_build.py` starts
// one nvcc per source at once): the kernels are flash_bwd_sm90.cu's, the entry
// points the branches' (its FLASH_BWD_BRANCHES section).
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_bwd_dkdv_kernel's
// causal, segment and mask branches (:977-986, skips :1012-1016) and
// ::_bwd_dq_kernel's (:1284-1293, skips :1306-1310) (Pallas, TPU).

#define FLASH_BWD_BRANCHES
#include "flash_bwd_sm90.cu"
