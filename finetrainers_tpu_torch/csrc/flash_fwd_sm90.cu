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
// grid, or a TMA store of the output. The Hopper helpers (barriers, TMA,
// wgmma wrappers, descriptors, tensor maps) are in sm90_common.cuh, shared
// with K2 and K3 (flash_bwd_sm90.cu).

#include "sm90_common.cuh"

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

  const uint32_t q_addr = base + L::kQ + cwg * 64 * 128;
  mbar_wait(q_full, 0);
  if (num_tiles > 0) {
    float s[64], alpha[2], rowsum[2];
    uint32_t pa[kBlockN / 16][4];
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, base + L::kK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_step(s, m, alpha, rowsum, 0, kv_len, lane);
    l[0] = rowsum[0];
    l[1] = rowsum[1];
    pack_a<T, kBlockN>(pa, s);
    for (int t = 1; t < num_tiles; ++t) {
      const int st = t % kStages, prev = (t - 1) % kStages;
      mbar_wait(k_full(st), (t / kStages) & 1);
      fence_regs<kOut>(o);
      wgmma_fence();
      issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, base + L::kK + st * L::kTileBytes);
      wgmma_commit();
      mbar_wait(v_full(prev), ((t - 1) / kStages) & 1);
      issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, base + L::kV + prev * L::kTileBytes);
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
      pack_a<T, kBlockN>(pa, s);
    }
    const int last = (num_tiles - 1) % kStages;
    mbar_wait(v_full(last), ((num_tiles - 1) / kStages) & 1);
    fence_regs<kOut>(o);
    wgmma_fence();
    issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, base + L::kV + last * L::kTileBytes);
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
    mbar_init_fence();
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

template <typename T, int HD>
cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map, const Params& p,
                   int batch, cudaStream_t stream) {
  const dim3 grid((p.seq_q + block_m<HD>() - 1) / block_m<HD>(), p.heads, batch);
  static std::atomic<uint64_t> attribute_set{0};
  // + 1024 bytes of slack to align the base to 1024 bytes
  return launch_sm90(flash_fwd_sm90_kernel<T, HD>, attribute_set, grid, threads<HD>(), Layout<HD>::kBytes + 1024,
                     stream, q_map, k_map, v_map, p);
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
