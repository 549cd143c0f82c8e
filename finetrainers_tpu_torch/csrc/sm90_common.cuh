// Hopper (sm_90a) building blocks shared by the wgmma kernels: K1 and K7a-c
// (flash_fwd_sm90.cu), K2/K3 and K5 (flash_bwd_sm90.cu) and K6 (sage_fwd_sm90.cu).
// Device side: the mbarrier helpers, TMA tile loads and reduces, setmaxnreg,
// named barriers, shared stores, the generic-to-async proxy fence, the wgmma
// fence/commit/wait, the register fences, the tile rows and shared-memory
// descriptors for the 128- and 64-byte swizzles (head dims 64/128 and 32) and
// the bf16/fp16 and int8 wgmma shape wrappers.
// Host side:
// cuTensorMapEncodeTiled from the loaded driver and the rank-4 (H, S, N, B)
// tensor maps over BNSH views of BTNH buffers.

#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <atomic>
#include <cstring>
#include <mutex>

#include "flash_common.cuh"

namespace {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// One arrival that also expects `bytes` of TMA writes before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 64-column box (box_rows rows of the map) of a rank-4 (H, S, N, B) tensor
// map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int h, int s, int n,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(h), "r"(s), "r"(n), "r"(b)
      : "memory");
}

// Add a box of fp32 shared memory at `src` into the rank-4 (H, S, N, B) map's
// box at (h, s, n, b) in device memory (TMA reduce; rows past S are dropped),
// in this thread's current bulk group.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int h, int s, int n, int b) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(h), "r"(s), "r"(n), "r"(b)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until this thread's bulk groups have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a multiple of 32.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory stores at a 32-bit shared address.
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// Make this thread's shared-memory writes visible to the async proxy (wgmma
// operand reads, TMA), and order them before the proxy's later writes.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Zero the rows [row_begin, row_end) of a 128-row tile of HD / 64 halves (each
// 128 rows of 128 bytes, kHalf bytes apart): the swizzle permutes 16-byte
// chunks inside a row, so whole rows are zeroed wherever they lie. `tid` and
// `threads` spread the 16-byte stores.
template <int HD, int HALF>
__device__ __forceinline__ void zero_tile_rows(unsigned char* tile, int row_begin, int row_end, int tid, int threads) {
  constexpr int kChunks = 8 * (HD / 64);  // 16-byte chunks of a row
  for (int idx = row_begin * kChunks + tid; idx < row_end * kChunks; idx += threads) {
    const int row = idx / kChunks, chunk = idx % kChunks;
    *reinterpret_cast<uint4*>(tile + (chunk / 8) * HALF + row * 128 + (chunk % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Wait until at most the last committed group is still running.
__device__ __forceinline__ void wgmma_wait_one() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (it does not see that the wait is what defines
// them), and from reusing the registers of an A fragment before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]), "+r"(a[i][3])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, each in 16-byte units, and the layout (1: the 128-byte swizzle, 2:
// the 64-byte one).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout = 1) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// The row of an operand tile of HD 2-byte columns in shared memory, as TMA
// writes it and wgmma reads it: at H >= 64 a 64-column half of the row (128
// bytes, the 128-byte swizzle; a tile is H / 64 such halves, a half's bytes
// apart); at H = 32 the whole row (64 bytes, the 64-byte swizzle; one box).
// kLayout is the descriptor's swizzle field.
template <int HD>
struct TileRow {
  static_assert(HD == 32 || HD == 64 || HD == 128, "the wgmma kernels take head dims 32, 64 and 128");
  static constexpr int kBytes = HD >= 64 ? 128 : 2 * HD;
  static constexpr int kCols = kBytes / 2;  // columns of one TMA box
  static constexpr int kBoxes = HD / kCols;
  static constexpr uint64_t kLayout = HD >= 64 ? 1 : 2;
};

// K-major operand (rows are M or N, the columns the contraction dim): 8-row
// groups are 8 rows apart (1024 bytes under the 128-byte swizzle, 512 under
// the 64-byte one); a k-step of 16 columns moves the start 32 bytes inside the
// swizzle row, past its end to the next 64-column half, HALF bytes on.
template <int HD = 64>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 8 * TileRow<HD>::kBytes, TileRow<HD>::kLayout);
}
template <int HALF, int HD = 64>
__device__ __forceinline__ uint32_t kmajor_step(int kk) {
  constexpr int kPerRow = TileRow<HD>::kBytes / 32;  // k-steps in one swizzle row
  return ((kk / kPerRow) * HALF + (kk % kPerRow) * 32) >> 4;
}

// MN-major operand (the B of a register-A product: rows are the contraction
// dim, the columns N): 8-row groups are 8 rows apart (SBO), 64-column halves
// `half` bytes apart (LBO; at H = 32 N is one 32-column swizzle atom, so LBO
// is never used); a k-step of 16 rows moves the start 16 rows.
template <int HD = 64>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t half) {
  return smem_desc(addr, half, 8 * TileRow<HD>::kBytes, TileRow<HD>::kLayout);
}
template <int HD = 64>
__device__ __forceinline__ uint32_t mnmajor_step(int kk) {
  return (kk * 16 * TileRow<HD>::kBytes) >> 4;
}

#define ACC8(i)                                                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define ACC16 ACC8(0), ACC8(8)
#define ACC32 ACC16, ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define OUT8(i)                                                                                                    \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), \
      "=f"(d[i + 7])
#define OUT32 OUT8(0), OUT8(8), OUT8(16), OUT8(24)
#define OUT64 OUT32, OUT8(32), OUT8(40), OUT8(48), OUT8(56)
#define REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// The wgmma shapes, for one input type TY ("bf16" or "f16"), fp32 accumulate:
//  ss64 / ss128: d (64 x 64 / 128) (+)= A (64 x 16, smem) B (16 x N, smem),
//         both K-major; scale_d 0 overwrites d.
//  ss64_new / ss128_new: d = A B, as ss64 / ss128 with scale_d 0, but d's
//         registers are outputs only, so their old values need not stay live.
//  rs32 / rs64 / rs128: d (64 x 32 / 64 / 128) (+)= A (64 x 16, registers) B (16 x N, smem, MN-major);
//         scale_d 0 overwrites d.
//  ss64_mn: d (64 x 64) (+)= A (64 x 16, smem) B (16 x 64, smem), both MN-major
//         (A's 64 rows contiguous along each contraction row).
#define DEFINE_WGMMA(TY)                                                                                         \
  static __device__ __forceinline__ void ss64(float* d, uint64_t a, uint64_t b, int scale_d) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n" \
                 : ACC32                                                                                         \
                 : "l"(a), "l"(b), "r"(scale_d));                                                                \
  }                                                                                                              \
  static __device__ __forceinline__ void ss128(float* d, uint64_t a, uint64_t b, int scale_d) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n" \
                 : ACC64                                                                                         \
                 : "l"(a), "l"(b), "r"(scale_d));                                                                \
  }                                                                                                              \
  static __device__ __forceinline__ void ss64_new(float* d, uint64_t a, uint64_t b) {                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n" \
                 : OUT32                                                                                         \
                 : "l"(a), "l"(b), "r"(0));                                                                      \
  }                                                                                                              \
  static __device__ __forceinline__ void ss128_new(float* d, uint64_t a, uint64_t b) {                         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n" \
                 : OUT64                                                                                         \
                 : "l"(a), "l"(b), "r"(0));                                                                      \
  }                                                                                                              \
  static __device__ __forceinline__ void ss64_mn(float* d, uint64_t a, uint64_t b, int scale_d) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32 ", %32, %33, p, 1, 1, 1, 1;\n}\n" \
                 : ACC32                                                                                         \
                 : "l"(a), "l"(b), "r"(scale_d));                                                                \
  }                                                                                                              \
  static __device__ __forceinline__ void rs32(float* d, const uint32_t* a, uint64_t b, int scale_d = 1) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " REGS16                              \
                 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                                 \
                 : ACC16                                                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));                           \
  }                                                                                                              \
  static __device__ __forceinline__ void rs64(float* d, const uint32_t* a, uint64_t b, int scale_d = 1) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32                              \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                 \
                 : ACC32                                                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));                           \
  }                                                                                                              \
  static __device__ __forceinline__ void rs128(float* d, const uint32_t* a, uint64_t b, int scale_d = 1) {      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " REGS64                             \
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                 \
                 : ACC64                                                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));                           \
  }

template <typename T>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16> {
  DEFINE_WGMMA("bf16")
};

template <>
struct Wgmma<__half> {
  DEFINE_WGMMA("f16")
};

#define IACC8(i)                                                                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), \
      "+r"(d[i + 7])
#define IACC64 IACC8(0), IACC8(8), IACC8(16), IACC8(24), IACC8(32), IACC8(40), IACC8(48), IACC8(56)

// d (64 x 128, s32) (+)= A (64 x 32, s8, smem) B (32 x 128, s8, smem), both
// K-major (8-bit wgmma has no transpose); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n128(int32_t* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " REGS64 ", %64, %65, p;\n}\n"
               : IACC64
               : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N) = A B^T over the contraction dim HD, both operands K-major in
// shared memory: A's 64 rows at `a_addr` in a tile whose halves are A_HALF
// bytes apart, B's N rows at `b_addr` in a tile whose halves are B_HALF bytes
// apart (HALF matters at H = 128 only). Issued, not waited for. NEW: the first
// k-step takes d's registers as outputs only (`ss*_new`), so d's old values die
// before the issue.
template <typename T, int HD, int N, int A_HALF, int B_HALF, bool NEW = false>
__device__ __forceinline__ void issue_ss(float* d, uint32_t a_addr, uint32_t b_addr) {
  const uint64_t a_desc = kmajor_desc<HD>(a_addr), b_desc = kmajor_desc<HD>(b_addr);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (NEW && N == 64) {
      if (kk == 0) {
        Wgmma<T>::ss64_new(d, a_desc, b_desc);
        continue;
      }
    } else if constexpr (NEW) {
      if (kk == 0) {
        Wgmma<T>::ss128_new(d, a_desc, b_desc);
        continue;
      }
    }
    if constexpr (N == 64) {
      Wgmma<T>::ss64(d, a_desc + kmajor_step<A_HALF, HD>(kk), b_desc + kmajor_step<B_HALF, HD>(kk), kk);
    } else {
      Wgmma<T>::ss128(d, a_desc + kmajor_step<A_HALF, HD>(kk), b_desc + kmajor_step<B_HALF, HD>(kk), kk);
    }
  }
}

// d (64 x HD) += A B over a contraction dim of K rows (d = A B with
// `overwrite`), A in registers (the packed accumulator of a 64 x K product), B's
// K rows at `b_addr`, MN-major, in a tile whose 64-column halves are B_HALF
// bytes apart. Issued, not waited for.
template <typename T, int HD, int K, int B_HALF>
__device__ __forceinline__ void issue_rs(float* d, uint32_t (*a)[4], uint32_t b_addr, bool overwrite = false) {
  const uint64_t b_desc = mnmajor_desc<HD>(b_addr, B_HALF);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int scale_d = overwrite && kk == 0 ? 0 : 1;
    if constexpr (HD == 32) {
      Wgmma<T>::rs32(d, a[kk], b_desc + mnmajor_step<HD>(kk), scale_d);
    } else if constexpr (HD == 64) {
      Wgmma<T>::rs64(d, a[kk], b_desc + mnmajor_step<HD>(kk), scale_d);
    } else {
      Wgmma<T>::rs128(d, a[kk], b_desc + mnmajor_step<HD>(kk), scale_d);
    }
  }
}

// A 64 x K accumulator fragment (values in fp32) as the A operand of a
// register-A product over K: round to T and pack, 16 columns per k-step.
template <typename T, int K>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a[kk][0] = Ops<T>::pack(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = Ops<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = Ops<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = Ops<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Two fp32 values rounded to T as one packed conversion rounds them (the same
// round-to-nearest-even as a cast), and back to fp32.
template <typename T>
__device__ __forceinline__ float2 round_pair(float a, float b) {
  return Ops<T>::unpack(Ops<T>::pack(a, b));
}

// Barrier initialisation made visible to the async proxy (TMA) and the CTA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process has loaded (no link to libcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A rank-4 (H, S, N, B) tensor map of box_cols x box_rows boxes over a (B, N,
// S, H) operand of `type` (elem_bytes each) with element strides (sb, sn, ss)
// and a contiguous H; TMA fills rows past S with 0. A size-1 dim's stride is
// never used; it is given a packed one. The last maps encoded are kept: a map
// depends on nothing but these arguments, and the caching allocator hands the
// same addresses back step after step, so most calls skip the driver.
inline bool encode_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem_bytes, int box_cols,
                       CUtensorMapSwizzle swizzle, int head_dim, int seq, int heads, int batch, int box_rows,
                       int64_t sb, int64_t sn, int64_t ss) {
  struct Key {
    const void* ptr;
    int64_t args[12];
  };
  constexpr int kCached = 64;
  static std::mutex mutex;
  static Key keys[kCached];
  static CUtensorMap maps[kCached];
  static int count = 0, next = 0;
  Key key = {ptr, {(int64_t)type, elem_bytes, box_cols, (int64_t)swizzle, head_dim, seq, heads, batch, box_rows, sb,
                   sn, ss}};
  {
    std::lock_guard<std::mutex> lock(mutex);
    for (int j = 1; j <= count; ++j) {  // newest first
      const int i = (next - j + kCached) % kCached;
      if (keys[i].ptr == key.ptr && std::memcmp(keys[i].args, key.args, sizeof(key.args)) == 0) {
        *map = maps[i];
        return true;
      }
    }
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || seq < 1) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq, (cuuint64_t)heads, (cuuint64_t)batch};
  const int64_t elem_strides[3] = {seq > 1 ? ss : head_dim, heads > 1 ? sn : (int64_t)seq * head_dim,
                                   batch > 1 ? sb : (int64_t)heads * seq * head_dim};
  const cuuint64_t strides[3] = {(cuuint64_t)(elem_strides[0] * elem_bytes), (cuuint64_t)(elem_strides[1] * elem_bytes),
                                 (cuuint64_t)(elem_strides[2] * elem_bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::lock_guard<std::mutex> lock(mutex);
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kCached;
  count = count < kCached ? count + 1 : kCached;
  return true;
}

// A bf16 (dtype 0) or fp16 (1) operand's map in boxes of box_rows rows of one
// TileRow: 64 columns under the 128-byte swizzle at H >= 64, the whole 32-column
// row under the 64-byte swizzle at H = 32.
inline bool encode_operand(CUtensorMap* map, const void* ptr, int dtype, int head_dim, int seq, int heads, int batch,
                           int box_rows, int64_t sb, int64_t sn, int64_t ss) {
  const bool narrow = head_dim < 64;
  return encode_map(map, ptr, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
                    narrow ? head_dim : 64, narrow ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                    head_dim, seq, heads, batch, box_rows, sb, sn, ss);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory and return
// `cudaGetLastError`. The caller keeps one `attribute_set` per kernel (bit d:
// the shared-memory attribute is set on device d), so it is set once.
template <typename Kernel, typename... Args>
cudaError_t launch_sm90(Kernel kernel, std::atomic<uint64_t>& attribute_set, dim3 grid, int threads, int smem,
                        cudaStream_t stream, const Args&... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  if (bit == 0 || !(attribute_set.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attribute_set.fetch_or(bit);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
