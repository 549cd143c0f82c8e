// Flash attention forward K1 for Hopper (sm_90a), CUDA C++: a warp-specialised
// kernel whose two products run on wgmma, fed by TMA through a ring of
// shared-memory stages.
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_fwd_kernel (:106; Pallas,
// TPU), driven there by _flash_forward (:689) through pallas_call (:852). It
// computes that function on the operands of the pre-pass (`rope_prep_kernel` in
// flash_bwd.cu, which the wrapper launches first): q_s = T(rope(q) * scale *
// log2(e)) and k_r = T(rope(k)), T() rounding to the input dtype. Then, in base 2:
//   s = q_s k_r^T (fp32), selected to -1e30 at keys >= kv_lens[b];
//   m_new = max(m, rowmax(s)); p = exp2(s - m_new); alpha = exp2(m - m_new);
//   l = l*alpha + rowsum(p); acc = acc*alpha + T(p) v;
//   out = T(acc / l) and the natural-log lse = m*ln2 + log(l); a row with no
//   valid key gives out 0 and lse -1e30*ln2.
//
// What bounds it on this card: at LTX's self-attention shape (B=2, N=32,
// S=2688, H=64) QK^T plus PV is 4*B*N*S*S*H = 118 GFLOP per call, against ~88
// MB of q_s, k_r, v and out (~132 MB with the fp32 RoPE tables the pre-pass
// reads): 900-1,340 operations per byte, far above the H100's ~295 FLOP/byte
// ridge; Wan's shape (S=19,968, H=128) is further above it. So it is bound by
// operations, and the tensor cores are the resource to feed.
//
// What this design does about it:
//  - The rotation and the q scaling run once per call, in the pre-pass, not
//    once per CTA on every k tile (the mma.sync K1 this replaces re-rotated all
//    of k in each of the S/128 CTAs of a head: ~42% of its time at Wan's shape).
//  - One CTA owns a q tile of one (batch, head): warpgroup 0 gives up its
//    registers (setmaxnreg) and one of its threads issues every TMA load; the
//    consumer warpgroups own 64 q rows each and run both products as wgmma,
//    the only path to the tensor cores' full rate. At H=128 two consumers
//    (128 rows, 240 registers each); at H=64 three (192 rows, 160 each).
//  - Shared memory holds the q tile, loaded once, and a ring of kStages k/v
//    stages of 128 keys, each with a full and an empty mbarrier, so the next
//    tiles load while the current one is computed. TMA writes them with the
//    128-byte swizzle that wgmma reads without bank conflicts. The operands are
//    described by rank-4 tensor maps (H, S, N, B) over their strides, so a BNSH
//    view of a BTNH buffer is read where it lies; TMA fills rows past S with 0.
//  - S = q_s k_r^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major: H is contiguous). The softmax recurrence runs in fp32 registers
//    on the accumulator fragments; p, rounded to T, stays in registers as the A
//    operand of P V (m64nHk16, v from shared memory, MN-major).
//  - Inside a warpgroup, tile t's QK^T is issued together with tile t-1's P V,
//    and tile t's softmax runs while that P V is still on the tensor cores; the
//    two warpgroups run unsynchronised, so one's softmax also overlaps the
//    other's products. This measured 10-20% faster than waiting for each
//    product in turn, and 2 stages faster than 3 (PERF.md).
//  - TMA reads the real rows of k and v between kv_lens[b] and S: the scores of
//    those keys are selected to -1e30 before the max, so their p is exactly 0
//    and they add nothing; the producer and the consumers stop at the last tile
//    that holds a valid key.
// Not yet used: an enforced ping-pong between the two warpgroups, a persistent
// grid, or a TMA store of the output.

#include <cuda.h>
#include <dlfcn.h>

#include "flash_common.cuh"

namespace {

constexpr int kBlockN = 128;  // keys per stage
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
// Consumer warpgroups per CTA, each owning 64 q rows: three at H=64, where the
// softmax is a larger share of a tile's work and a third warpgroup hides more
// of it (measured ~13% faster at LTX's shape than two); two at H=128, where
// three sets of accumulators would not fit the register file.
template <int HD>
__host__ __device__ constexpr int consumer_wgs() {
  return HD == 64 ? 3 : 2;
}
template <int HD>
__host__ __device__ constexpr int block_m() {  // q rows per CTA
  return 64 * consumer_wgs<HD>();
}
template <int HD>
__host__ __device__ constexpr int threads() {  // warpgroup 0 loads; the others compute
  return 128 * (1 + consumer_wgs<HD>());
}
// The consumers' registers after setmaxnreg: what the producer's 128 threads
// give up, shared among them (a multiple of 8).
template <int HD>
__host__ __device__ constexpr int consumer_regs() {
  return HD == 64 ? 160 : 240;
}
// A 64-column half of a 128-row tile: 128 rows of 128 bytes, one TMA box.
constexpr int kHalfBytes = 128 * 128;

// Byte offsets in shared memory (from a 1024-byte aligned base, as the
// 128-byte swizzle needs): the q tile, kStages k tiles, kStages v tiles, then
// the barriers q_full, k_full[kStages], v_full[kStages], k_empty[kStages],
// v_empty[kStages].
template <int HD>
struct Layout {
  static constexpr int kTileBytes = HD / 64 * kHalfBytes;
  static constexpr int kQBytes = block_m<HD>() * HD * 2;
  static_assert(HD == 64 || block_m<HD>() == 128, "the q tile's 64-column halves must be kHalfBytes apart");
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
};

struct Params {
  void* out;
  float* lse;          // (B, N, Sq) contiguous
  const int* kv_lens;  // (B,) or nullptr
  int heads, seq_q, seq_kv;
  int64_t o_sb, o_sn, o_ss;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

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

// One 64-column box (128 k/v rows, or the q tile's rows) of a rank-4 (H, S, N,
// B) tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int h, int s, int n,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(h), "r"(s), "r"(n), "r"(b)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
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
__device__ __forceinline__ void fence_regs(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]), "+r"(a[i][3])::"memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major tile (q, k: rows of 64-column halves, 128 bytes each): 8-row groups
// are 1024 bytes apart; a k-step of 16 columns moves the start 32 bytes inside
// the swizzle row, a 64-column half moves it by kHalfBytes.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return smem_desc(addr, 16, 1024); }
__device__ __forceinline__ uint32_t kmajor_step(int kk) { return ((kk / 4) * kHalfBytes + (kk % 4) * 32) >> 4; }

// MN-major tile (v as the B operand of P V: keys are the contraction dim, H
// contiguous): 8-key groups are 1024 bytes apart (SBO), 64-column halves
// kHalfBytes apart (LBO); a k-step of 16 keys moves the start 2048 bytes.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) { return smem_desc(addr, kHalfBytes, 1024); }

#define ACC8(i)                                                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// The three wgmma shapes, for one input type TY ("bf16" or "f16"), fp32 accumulate:
//  ss128: d (64 x 128) (+)= A (64 x 16, smem) B (16 x 128, smem), both K-major;
//         scale_d 0 overwrites d.
//  rs64 / rs128: d (64 x 64 / 128) += A (64 x 16, registers) B (16 x N, smem, MN-major).
#define DEFINE_WGMMA(TY)                                                                                         \
  static __device__ __forceinline__ void ss128(float* d, uint64_t a, uint64_t b, int scale_d) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n" \
                 : ACC64                                                                                         \
                 : "l"(a), "l"(b), "r"(scale_d));                                                                \
  }                                                                                                              \
  static __device__ __forceinline__ void rs64(float* d, const uint32_t* a, uint64_t b) {                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32                              \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                 \
                 : ACC32                                                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                                 \
  }                                                                                                              \
  static __device__ __forceinline__ void rs128(float* d, const uint32_t* a, uint64_t b) {                       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                    \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " REGS64                             \
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                 \
                 : ACC64                                                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                                 \
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

// The producer: one thread of warpgroup 0 loads the q tile once, then k and v
// tile t into stage t % kStages once the consumers have released it.
template <int HD>
__device__ __forceinline__ void produce(const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        uint32_t base, int q0, int n, int b, int num_tiles) {
  using L = Layout<HD>;
  const uint32_t q_full = base + L::kBars;
  mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
  for (int h = 0; h < HD / 64; ++h) tma_load(base + L::kQ + h * kHalfBytes, q_map, q_full, h * 64, q0, n, b);
  for (int t = 0; t < num_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = ((t / kStages) & 1) ^ 1;  // the first round finds every stage free
    const uint32_t k_full = q_full + 8 * (1 + st), v_full = k_full + 8 * kStages;
    const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;
    mbar_wait(k_empty, parity);
    mbar_expect_tx(k_full, L::kTileBytes);
#pragma unroll
    for (int h = 0; h < HD / 64; ++h)
      tma_load(base + L::kK + st * L::kTileBytes + h * kHalfBytes, k_map, k_full, h * 64, t * kBlockN, n, b);
    mbar_wait(v_empty, parity);
    mbar_expect_tx(v_full, L::kTileBytes);
#pragma unroll
    for (int h = 0; h < HD / 64; ++h)
      tma_load(base + L::kV + st * L::kTileBytes + h * kHalfBytes, v_map, v_full, h * 64, t * kBlockN, n, b);
  }
}

// S = q_s k_r^T for one 128-key tile, issued (not waited for).
template <typename T, int HD>
__device__ __forceinline__ void issue_qk(float* s, uint64_t q_desc, uint32_t k_addr) {
  const uint64_t k_desc = kmajor_desc(k_addr);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) Wgmma<T>::ss128(s, q_desc + kmajor_step(kk), k_desc + kmajor_step(kk), kk);
}

// o += P V for one tile, P from registers, issued (not waited for).
template <typename T, int HD>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pa)[4], uint32_t v_addr) {
  const uint64_t v_desc = mnmajor_desc(v_addr);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    if constexpr (HD == 64) {
      Wgmma<T>::rs64(o, pa[kk], v_desc + ((kk * 2048) >> 4));
    } else {
      Wgmma<T>::rs128(o, pa[kk], v_desc + ((kk * 2048) >> 4));
    }
  }
}

// The softmax step on a landed score tile: keys at or past kv_len selected
// out, the running max m moved on, s overwritten by p = exp2(s - m), and the
// rescale alpha and this tile's row sums returned.
__device__ __forceinline__ void softmax_step(float* s, float* m, float* alpha, float* rowsum, int k0, int kv_len,
                                             int lane) {
  if (k0 + kBlockN > kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= kv_len) s[i] = kNegInf;
    }
  }
  float tmax[2] = {2.f * kNegInf, 2.f * kNegInf};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    tmax[0] = fmaxf(tmax[0], fmaxf(s[4 * j], s[4 * j + 1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    rowsum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
    rowsum[(i >> 1) & 1] += s[i];
  }
}

template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    pa[kk][0] = Ops<T>::pack(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = Ops<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = Ops<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = Ops<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A consumer warpgroup (`cwg` 0, 1 or 2) owning q rows q0 + 64*cwg ... Each thread
// holds two rows, (thread % 128) / 4 % 8 + 16 * warp and 8 below it, in the
// wgmma accumulator layout: element 4j+e of a fragment is at column
// 8j + 2*(lane%4) + (e&1) of row lane/4 + 8*(e>=2) of the warp's 16 rows.
// Tile t's QK^T is issued together with tile t-1's P V, and tile t's softmax
// runs while that P V is on the tensor cores.
template <typename T, int HD>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, int cwg, int q0, int n, int b, int kv_len,
                                        int num_tiles) {
  using L = Layout<HD>;
  constexpr int kOut = HD / 2;  // accumulator floats per thread: 64 rows x HD / 128 threads
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * kStages + st); };

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced over the quad at the end

  const uint64_t q_desc = kmajor_desc(base + L::kQ + cwg * 64 * 128);
  mbar_wait(q_full, 0);
  if (num_tiles > 0) {
    float s[64], alpha[2], rowsum[2];
    uint32_t pa[kBlockN / 16][4];
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_qk<T, HD>(s, q_desc, base + L::kK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_step(s, m, alpha, rowsum, 0, kv_len, lane);
    l[0] = rowsum[0];
    l[1] = rowsum[1];
    pack_p<T>(pa, s);
    for (int t = 1; t < num_tiles; ++t) {
      const int st = t % kStages, prev = (t - 1) % kStages;
      mbar_wait(k_full(st), (t / kStages) & 1);
      fence_regs<kOut>(o);
      wgmma_fence();
      issue_qk<T, HD>(s, q_desc, base + L::kK + st * L::kTileBytes);
      wgmma_commit();
      mbar_wait(v_full(prev), ((t - 1) / kStages) & 1);
      issue_pv<T, HD>(o, pa, base + L::kV + prev * L::kTileBytes);
      wgmma_commit();
      wgmma_wait_one();  // QK^T of tile t has landed; P V of tile t-1 may still run
      fence_regs<64>(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(st));
      softmax_step(s, m, alpha, rowsum, t * kBlockN, kv_len, lane);
      wgmma_wait_all();
      fence_regs<kOut>(o);
      fence_regs<kBlockN / 16>(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(prev));
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i] *= alpha[(i >> 1) & 1];
      l[0] = l[0] * alpha[0] + rowsum[0];
      l[1] = l[1] * alpha[1] + rowsum[1];
      pack_p<T>(pa, s);
    }
    const int last = (num_tiles - 1) % kStages;
    mbar_wait(v_full(last), ((num_tiles - 1) / kStages) & 1);
    fence_regs<kOut>(o);
    wgmma_fence();
    issue_pv<T, HD>(o, pa, base + L::kV + last * L::kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kOut>(o);
    fence_regs<kBlockN / 16>(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(last));
  }

  // out = acc / l in T, lse = m*ln2 + log(l); a row with no valid key has l = 0: out 0, lse -1e30*ln2.
  T* out = static_cast<T*>(p.out) + b * p.o_sb + n * p.o_sn;
  const int row0 = q0 + cwg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
    const float inv = 1.f / l[r];
    const int row = row0 + 8 * r;
    if (row >= p.seq_q) continue;
    T* orow = out + row * p.o_ss + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) = Ops<T>::pack(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    if (lane % 4 == 0) p.lse[((int64_t)b * p.heads + n) * p.seq_q + row] = m[r] * kLn2 + logf(l[r]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(threads<HD>(), 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + Layout<HD>::kBars;
  const int q0 = blockIdx.x * block_m<HD>(), n = blockIdx.y, b = blockIdx.z;
  int kv_len = p.seq_kv;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.seq_kv);
  const int num_tiles = (kv_len + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full + 8 * (1 + st), 1);                                     // k_full
      mbar_init(q_full + 8 * (1 + kStages + st), 1);                           // v_full
      mbar_init(q_full + 8 * (1 + 2 * kStages + st), 4 * consumer_wgs<HD>());  // k_empty: one arrival a warp
      mbar_init(q_full + 8 * (1 + 3 * kStages + st), 4 * consumer_wgs<HD>());  // v_empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the whole lifetime of each role, so setmaxnreg applies.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce<HD>(&q_map, &k_map, &v_map, base, q0, n, b, num_tiles);
  } else {
    setmaxnreg_inc<consumer_regs<HD>()>();
    consume<T, HD>(p, base, threadIdx.x / 128 - 1, q0, n, b, kv_len, num_tiles);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process has loaded (no link to libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A rank-4 (H, S, N, B) tensor map of 64 x box_rows boxes with the 128-byte
// swizzle over a (B, N, S, H) operand with element strides (sb, sn, ss) and a
// contiguous H. A size-1 dim's stride is never used; it is given a packed one.
bool encode_operand(CUtensorMap* map, const void* ptr, int dtype, int head_dim, int seq, int heads, int batch,
                    int box_rows, int64_t sb, int64_t sn, int64_t ss) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || seq < 1) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq, (cuuint64_t)heads, (cuuint64_t)batch};
  const int64_t elem_strides[3] = {seq > 1 ? ss : head_dim, heads > 1 ? sn : (int64_t)seq * head_dim,
                                   batch > 1 ? sb : (int64_t)heads * seq * head_dim};
  const cuuint64_t strides[3] = {(cuuint64_t)elem_strides[0] * 2, (cuuint64_t)elem_strides[1] * 2,
                                 (cuuint64_t)elem_strides[2] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map, const Params& p,
                   int batch, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<T, HD>;
  const int smem = Layout<HD>::kBytes + 1024;  // + the slack to align the base to 1024 bytes
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_q + block_m<HD>() - 1) / block_m<HD>(), p.heads, batch);
  kernel<<<grid, threads<HD>(), smem, stream>>>(q_map, k_map, v_map, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q_s and k_r are the pre-pass's
// operands (k itself when there are no RoPE tables); dtype: 0 = bf16, 1 = fp16;
// strides: q_s, k_r, v, out, each (batch, head, seq), in elements; the head dim
// is contiguous and every operand 16-byte aligned. Returns a cudaError_t
// (cudaErrorInvalidValue also when a tensor map cannot be encoded).
extern "C" int flash_fwd_sm90(const void* q_s, const void* k_r, const void* v, void* out, void* lse,
                              const void* kv_lens, int batch, int heads, int seq_q, int seq_kv, int head_dim,
                              int dtype, const int64_t* strides, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  const int q_rows = head_dim == 64 ? block_m<64>() : block_m<128>();
  if (!encode_operand(&q_map, q_s, dtype, head_dim, seq_q, heads, batch, q_rows, strides[0], strides[1], strides[2]) ||
      !encode_operand(&k_map, k_r, dtype, head_dim, seq_kv, heads, batch, kBlockN, strides[3], strides[4],
                      strides[5]) ||
      !encode_operand(&v_map, v, dtype, head_dim, seq_kv, heads, batch, kBlockN, strides[6], strides[7], strides[8]))
    return cudaErrorInvalidValue;
  Params p;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_ss = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<__nv_bfloat16, 64>(q_map, k_map, v_map, p, batch, s);
  if (dtype == 0) return launch<__nv_bfloat16, 128>(q_map, k_map, v_map, p, batch, s);
  if (head_dim == 64) return launch<__half, 64>(q_map, k_map, v_map, p, batch, s);
  return launch<__half, 128>(q_map, k_map, v_map, p, batch, s);
}
