// Flash attention backward for Hopper (sm_90a), CUDA C++: K2 (dk, dv) and K3
// (dq) as warp-specialised kernels whose products all run on wgmma, fed by TMA
// through rings of shared-memory stages.
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_bwd_dkdv_kernel (K2, :888)
// and ::_bwd_dq_kernel (K3, :1199) (Pallas, TPU), driven there by
// _flash_backward through pallas_call (:1470, :1502). They compute those
// functions on the operands of the pre-pass (`rope_prep_kernel` in
// flash_bwd.cu, which the wrapper launches first): q_s = T(rope(q) * scale *
// log2(e)) and k_r = T(rope(k)), T() rounding to the input dtype. Then, at the
// JAX kernels' rounding points, in base 2:
//   s  = q_s k_r^T (fp32);  p = T(exp2(s - lse * log2(e))), selected (never
//        multiplied) to 0 at keys >= kv_lens[b] and at q rows >= Sq;
//   dv = sum_q p^T dO -> T;  dp = dO v^T;  ds = T(p * T(dp - delta)), selected
//        to 0 where p is;
//   dk = rope^T(ln2 * sum_q ds^T q_s) with k's tables -> T;
//   dq = rope^T(scale * sum_kv ds k_r) with q's tables -> T;
// rope^T is the transpose rotation g*cos - rotate(g)*sin (`_rope_bwd`); delta
// = rowsum(dO * out) comes from the caller (torch, as JAX computes it outside
// Pallas). A key tile at or past kv_lens[b] gets dk = dv = 0; a batch row with
// no valid key gets dq = 0.
//
// What bounds them on this card: at Wan's training shape (B=1, N=12,
// S=19,968, H=128) K2 does four products, 8*N*Sq*Skv*H = 4.90 TFLOP, and K3
// three, 3.67 TFLOP, against ~0.4 GB of q_s, k_r, v, dO, LSE, delta, tables
// and gradients: over 10,000 operations per byte, far above the H100's ~295
// FLOP/byte ridge. So both are bound by operations (4.95 and 3.72 ms at the
// bf16 peak), and the tensor cores are the resource to feed. With
// cross-attention over 128-512 keys the products shrink 40-150-fold and K2
// runs out of kv tiles to spread over 132 SMs.
//
// What this design does about it:
//  - Every product is a wgmma, the only path to the tensor cores' full rate.
//    Warpgroup 0 gives up its registers (setmaxnreg); one warp of it issues
//    every TMA load. Two consumer warpgroups own 64 rows each (240 registers).
//  - K2: one CTA owns 128 kv rows of one (batch, head). k_r and v are loaded
//    once; a ring of 3 stages streams q_s and dO tiles of 64 q rows with their
//    base-2 LSE and delta rows, each stage with a full and an empty mbarrier
//    (2 or 4 stages measured the same). Everything is computed kv-major, as
//    the mma.sync K2 did, so p and ds never need a transpose and never pass
//    through shared memory: s^T = k_r q_s^T and dp^T = v dO^T have both
//    operands in shared memory, K-major; dv += p^T dO and dk += ds^T q_s take
//    p^T and ds^T from registers (the accumulator fragments, rounded and
//    packed) and read dO and q_s MN-major from the same tiles. The grid's x
//    runs over the kv tiles of one head, so the CTAs resident together read
//    the same q_s and dO tiles out of L2.
//  - Where a head has too few kv tiles to fill the card (cross-attention), the
//    wrapper splits each CTA's q loop over `splits` CTAs; each writes fp32
//    partial dk and dv, and `dkdv_reduce_kernel` sums them, applies ln2 and the
//    transpose rotation and casts.
//  - K3: one CTA owns 128 q rows. q_s and dO are loaded once; a ring of 2
//    stages streams k_r and v tiles of 128 keys up to the last tile that holds
//    a valid key. s = q_s k_r^T and dp = dO v^T have both operands in shared
//    memory; dq += ds k_r takes ds from registers and reads k_r MN-major. The
//    LSE and delta of a thread's two rows stay in registers.
//  - In both, the second score-shaped product (dp) is issued with the first,
//    and p is computed while it runs (K2 then issues dv += p^T dO, which runs
//    while ds is computed); a tile's gradient products are waited for only
//    after the next tile's score products are issued; the two warpgroups run
//    unsynchronised, so one's exp2 also overlaps the other's products. p and
//    ds are rounded to T two at a time by the packed conversion that also
//    makes the A operand: one conversion per pair instead of one per value
//    and rounding point.
//  - TMA reads the real rows of k and v between kv_lens[b] and Skv (and fills
//    rows past S with 0): p and ds there are selected to 0, so they add
//    nothing, whatever those rows hold.
// Tried and left out: ordering the two warpgroups' score products with named
// barriers (ping-pong) measured 2% slower for K2 and 17% for K3. Not yet
// used: a persistent grid, TMA stores of the gradients.

#include "sm90_common.cuh"

namespace {

constexpr int kDkdvStages = 3;  // K2's q_s/dO ring (32 KB a stage at H=128, 16 KB at H=64)
constexpr int kDqStages = 2;    // K3's k_r/v ring (64 KB a stage at H=128: two fit beside q_s and dO)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 loads; the others compute
constexpr int kBlockRows = 64 * kConsumers;       // rows a CTA owns: kv rows in K2, q rows in K3
constexpr int kBlockKv = 128;                     // K3's streamed kv tile
constexpr int kHalf = 128 * 128;                  // a 64-column half of a 128-row tile: one TMA box
// K2's streamed q tile. With dk and dv (128 of a consumer's 240 registers at
// H=128) and the previous tile's p^T and ds^T live while the next tile's s^T
// and dp^T land, a 128-row tile would not fit the register file.
constexpr int kBlockQ = 64;

struct BwdParams {
  const float* lse;       // (B, N, Sq) natural log
  const float* delta;     // (B, N, Sq)
  const int* kv_lens;     // (B,) or nullptr
  const float* rope_cos;  // (N or 1, S, H) contiguous, or nullptr
  const float* rope_sin;
  void* dk;  // K2: dk, or with splits > 1 the fp32 (splits, B, N, Skv, H) partials; K3: dq
  void* dv;  // K2: dv, or the fp32 partials
  int batch, heads, seq_q, seq_kv;
  int splits, q_tiles_per_split;  // K2: CTAs sharing one kv tile's q loop, and the q tiles each takes
  int64_t dk_sb, dk_sn, dk_ss;    // K3: dq's
  int64_t dv_sb, dv_sn, dv_ss;
  int64_t rope_sn;
  float scale;  // K3: the softmax scale, applied to dq at emit
};

__device__ __forceinline__ int kv_length(const BwdParams& p, int b) {
  return p.kv_lens != nullptr ? min(max(p.kv_lens[b], 0), p.seq_kv) : p.seq_kv;
}

// Byte offsets in K2's shared memory (from a 1024-byte aligned base): the k_r
// and v tiles, kDkdvStages q_s and dO tiles, kDkdvStages rows of base-2 LSE
// and of delta, then the barriers kv_full, full[kDkdvStages],
// empty[kDkdvStages].
template <int HD>
struct DkdvLayout {
  static constexpr int kBq = kBlockQ;
  static constexpr int kKvBytes = HD / 64 * kHalf;
  static constexpr int kQHalf = kBq * 128;  // a 64-column half of a q_s or dO tile
  static constexpr int kQBytes = HD / 64 * kQHalf;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBytes;
  static constexpr int kQ = kV + kKvBytes;
  static constexpr int kDo = kQ + kDkdvStages * kQBytes;
  static constexpr int kLse = kDo + kDkdvStages * kQBytes;
  static constexpr int kDelta = kLse + kDkdvStages * kBq * 4;
  static constexpr int kBars = kDelta + kDkdvStages * kBq * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDkdvStages);
};

// K2's producer, warp 0: k_r and v once, then q tile t0 + i into stage
// i % kDkdvStages once the consumers have released it. Lane 0 issues the TMA
// loads; every lane stages the tile's base-2 LSE and delta (0 past Sq). A full
// barrier completes on lane 0's expect-tx arrival, the 32 lanes' arrivals
// after their stores, and the TMA bytes.
template <int HD>
__device__ __forceinline__ void dkdv_produce(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                             const CUtensorMap* v_map, const CUtensorMap* do_map, const BwdParams& p,
                                             uint32_t base, unsigned char* smem, int kv0, int n, int b, int t0,
                                             int num_tiles) {
  using L = DkdvLayout<HD>;
  constexpr int kPerLane = L::kBq / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t kv_full = base + L::kBars;
  if (lane == 0) {
    mbar_expect_tx(kv_full, 2 * L::kKvBytes);
#pragma unroll
    for (int h = 0; h < HD / 64; ++h) {
      tma_load(base + L::kK + h * kHalf, k_map, kv_full, h * 64, kv0, n, b);
      tma_load(base + L::kV + h * kHalf, v_map, kv_full, h * 64, kv0, n, b);
    }
  }
  const int64_t rows = ((int64_t)b * p.heads + n) * p.seq_q;
  for (int i = 0; i < num_tiles; ++i) {
    const int st = i % kDkdvStages;
    const int q0 = (t0 + i) * L::kBq;
    const uint32_t full = kv_full + 8 * (1 + st), empty = full + 8 * kDkdvStages;
    float lse2[kPerLane], dl[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {  // loaded before the wait, so the wait hides their latency
      const int row = q0 + lane + 32 * r;
      lse2[r] = row < p.seq_q ? p.lse[rows + row] * kLog2e : 0.f;
      dl[r] = row < p.seq_q ? p.delta[rows + row] : 0.f;
    }
    mbar_wait(empty, ((i / kDkdvStages) & 1) ^ 1);  // the first round finds every stage free
    if (lane == 0) {
      mbar_expect_tx(full, 2 * L::kQBytes);
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) {
        tma_load(base + L::kQ + st * L::kQBytes + h * L::kQHalf, q_map, full, h * 64, q0, n, b);
        tma_load(base + L::kDo + st * L::kQBytes + h * L::kQHalf, do_map, full, h * 64, q0, n, b);
      }
    }
    float* s_lse = reinterpret_cast<float*>(smem + L::kLse) + st * L::kBq;
    float* s_delta = reinterpret_cast<float*>(smem + L::kDelta) + st * L::kBq;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      s_lse[lane + 32 * r] = lse2[r];
      s_delta[lane + 32 * r] = dl[r];
    }
    mbar_arrive(full);
  }
}

// A consumer warpgroup of K2 (`cwg` 0 or 1) owning kv rows kv0 + 64*cwg ...
// Each thread holds two kv rows, row0 = kv0 + 64*cwg + 16*warp + lane/4 and
// row0 + 8, in the wgmma accumulator layout: element 4j+e of a fragment is at
// column 8j + 2*(lane%4) + (e&1) (a q row of s^T, an H column of dk/dv) of row
// row0 + 8*(e>>1).
template <typename T, int HD>
__device__ __forceinline__ void dkdv_consume(const BwdParams& p, uint32_t base, const unsigned char* smem, int cwg,
                                             int kv0, int n, int b, int split, int t0, int num_tiles, int kv_len) {
  using L = DkdvLayout<HD>;
  constexpr int kBq = L::kBq;
  constexpr int kS = kBq / 2;   // score floats per thread: 64 x kBq over 128 threads
  constexpr int kAcc = HD / 2;  // dk or dv floats per thread: 64 x HD over 128 threads
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t kv_full = base + L::kBars;
  const int row0 = kv0 + 64 * cwg + 16 * warp + lane / 4;
  const bool row_ok[2] = {row0 < kv_len, row0 + 8 < kv_len};
  const bool rows_all_valid = kv0 + kBlockRows <= kv_len;
  const uint32_t k_addr = base + L::kK + cwg * 64 * 128, v_addr = base + L::kV + cwg * 64 * 128;

  float dk[kAcc], dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[kBq / 16][4], da[kBq / 16][4];  // p^T and ds^T, rounded to T and packed: the A operands
  const int c = 2 * (lane % 4);
  mbar_wait(kv_full, 0);
  for (int i = 0; i < num_tiles; ++i) {
    const int st = i % kDkdvStages;
    const uint32_t full = kv_full + 8 * (1 + st);
    const uint32_t q_addr = base + L::kQ + st * L::kQBytes, do_addr = base + L::kDo + st * L::kQBytes;
    const float* lse2 = reinterpret_cast<const float*>(smem + L::kLse) + st * kBq;
    const float* delta = reinterpret_cast<const float*>(smem + L::kDelta) + st * kBq;
    const int q0 = (t0 + i) * kBq;
    const bool all_valid = rows_all_valid && q0 + kBq <= p.seq_q;
    // Element pair (8kk + 2e, +1) of a fragment: kv row row0 + 8*(e & 1), q columns q0 + 8j + c and + 1.
    auto valid = [&](int kk, int e, int dq) {
      return all_valid || (row_ok[e & 1] && q0 + 8 * (2 * kk + (e >> 1)) + c + dq < p.seq_q);
    };
    mbar_wait(full, (i / kDkdvStages) & 1);

    float s[kS], dp[kS];
    wgmma_fence();
    issue_ss<T, HD, kBq, kHalf, L::kQHalf>(s, k_addr, q_addr);  // s^T = k_r q_s^T
    wgmma_commit();
    issue_ss<T, HD, kBq, kHalf, L::kQHalf>(dp, v_addr, do_addr);  // dp^T = v dO^T
    wgmma_commit();
    // s^T has landed, and so have the previous tile's dv and dk products, issued
    // before it: that tile's stage is free. dp^T may still run.
    wgmma_wait_one();
    fence_regs<kS>(s);
    if (i > 0) {
      fence_regs<kAcc>(dk);
      fence_regs<kBq / 16>(pa);
      fence_regs<kBq / 16>(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_full + 8 * (1 + kDkdvStages + (i - 1) % kDkdvStages));
    }
    // p = T(exp2(s - lse * log2e)), selected to 0 at kv rows >= kv_len and q rows >= Sq
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 8 * kk + 2 * e;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * (2 * kk + (e >> 1)) + c);
        const float p0 = fast_exp2(s[x] - l2.x), p1 = fast_exp2(s[x + 1] - l2.y);
        pa[kk][e] = Ops<T>::pack(valid(kk, e, 0) ? p0 : 0.f, valid(kk, e, 1) ? p1 : 0.f);
      }
    }
    fence_regs<kAcc>(dv);
    wgmma_fence();
    issue_rs<T, HD, kBq, L::kQHalf>(dv, pa, do_addr);  // dv += p^T dO, running while ds is computed
    wgmma_commit();
    wgmma_wait_one();  // dp^T has landed
    fence_regs<kS>(dp);
    // ds = T(p * T(dp - delta)), selected to 0 where p is
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 8 * kk + 2 * e;
        const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * (2 * kk + (e >> 1)) + c);
        const float2 pv = Ops<T>::unpack(pa[kk][e]);
        const float2 d = round_pair<T>(dp[x] - d2.x, dp[x + 1] - d2.y);
        da[kk][e] = Ops<T>::pack(valid(kk, e, 0) ? pv.x * d.x : 0.f, valid(kk, e, 1) ? pv.y * d.y : 0.f);
      }
    }
    fence_regs<kAcc>(dk);
    wgmma_fence();
    issue_rs<T, HD, kBq, L::kQHalf>(dk, da, q_addr);  // dk += ds^T q_s
    wgmma_commit();  // dv and dk are waited for after the next tile's s^T is issued
  }
  wgmma_wait_all();
  fence_regs<kAcc>(dv);
  fence_regs<kAcc>(dk);
  fence_regs<kBq / 16>(pa);
  fence_regs<kBq / 16>(da);

  if (p.splits == 1) {
    // dk carries a surplus log2(e) (the scale*log2e folded into q_s, less the
    // scale ds lacks): ln2 undoes it. Then the transpose rotation, with k's rows.
    T* dk_out = static_cast<T*>(p.dk) + b * p.dk_sb + n * p.dk_sn;
    T* dv_out = static_cast<T*>(p.dv) + b * p.dv_sb + n * p.dv_sn;
    const float* cos = p.rope_cos != nullptr ? p.rope_cos + n * p.rope_sn : nullptr;
    const float* sin = p.rope_sin != nullptr ? p.rope_sin + n * p.rope_sn : nullptr;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.seq_kv) continue;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        float2 g = make_float2(dk[4 * i + 2 * r] * kLn2, dk[4 * i + 2 * r + 1] * kLn2);
        if (cos != nullptr) {
          const int64_t t = (int64_t)row * HD + col;
          g = rope_bwd_pair(g.x, g.y, cos + t, sin + t);
        }
        *reinterpret_cast<uint32_t*>(dk_out + row * p.dk_ss + col) = Ops<T>::pack(g.x, g.y);
        *reinterpret_cast<uint32_t*>(dv_out + row * p.dv_ss + col) =
            Ops<T>::pack(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  } else {
    const int64_t at = (((int64_t)split * p.batch + b) * p.heads + n) * p.seq_kv * HD;
    float* dk_part = static_cast<float*>(p.dk) + at;
    float* dv_part = static_cast<float*>(p.dv) + at;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.seq_kv) continue;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int64_t t = (int64_t)row * HD + 8 * i + 2 * (lane % 4);
        *reinterpret_cast<float2*>(dk_part + t) = make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(dv_part + t) = make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// K2: one CTA per (kv tile of kBlockRows rows, head, batch x split); split s
// takes q tiles [s * q_tiles_per_split, (s + 1) * q_tiles_per_split).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                         const BwdParams p) {
  using L = DkdvLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  const int kv0 = blockIdx.x * kBlockRows, n = blockIdx.y;
  const int b = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int kv_len = kv_length(p, b);
  if (kv0 >= kv_len) {  // every key of this tile is masked: dk = dv = 0 (split: the reduce pass writes them)
    if (p.splits == 1) {
      T* dk_out = static_cast<T*>(p.dk) + b * p.dk_sb + n * p.dk_sn;
      T* dv_out = static_cast<T*>(p.dv) + b * p.dv_sb + n * p.dv_sn;
      for (int idx = threadIdx.x; idx < kBlockRows * (HD / 8); idx += kThreads) {
        const int row = kv0 + idx / (HD / 8), col = (idx % (HD / 8)) * 8;
        if (row >= p.seq_kv) break;
        *reinterpret_cast<uint4*>(dk_out + row * p.dk_ss + col) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv_out + row * p.dv_ss + col) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int q_tiles = (p.seq_q + L::kBq - 1) / L::kBq;
  const int t0 = split * p.q_tiles_per_split;
  const int num_tiles = max(0, min(q_tiles - t0, p.q_tiles_per_split));

  const uint32_t kv_full = base + L::kBars;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kDkdvStages; ++st) {
      mbar_init(kv_full + 8 * (1 + st), 1 + 32);                   // full: lane 0's expect-tx + 32 lanes
      mbar_init(kv_full + 8 * (1 + kDkdvStages + st), 4 * kConsumers);  // empty: one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // One if/else for the whole lifetime of each role, so setmaxnreg applies.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) dkdv_produce<HD>(&q_map, &k_map, &v_map, &do_map, p, base, smem, kv0, n, b, t0, num_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dkdv_consume<T, HD>(p, base, smem, threadIdx.x / 128 - 1, kv0, n, b, split, t0, num_tiles, kv_len);
  }
}

// K2's reduce pass after a split q loop: dk = T(rope^T(ln2 * sum of the
// partials)) with k's tables, dv = T(sum), 0 at keys >= kv_lens[b]; one column
// pair per thread, grid-stride.
template <typename T, int HD>
__global__ void __launch_bounds__(256) dkdv_reduce_kernel(const float* dk_part, const float* dv_part,
                                                          const BwdParams p) {
  const int64_t rows = (int64_t)p.batch * p.heads * p.seq_kv;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < rows * (HD / 2);
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int col = (int)(idx % (HD / 2)) * 2;
    const int64_t row = idx / (HD / 2);  // (b, n, s) flattened
    const int s = (int)(row % p.seq_kv);
    const int n = (int)((row / p.seq_kv) % p.heads);
    const int b = (int)(row / ((int64_t)p.seq_kv * p.heads));
    float2 gk = make_float2(0.f, 0.f), gv = make_float2(0.f, 0.f);
    if (s < kv_length(p, b)) {
      for (int split = 0; split < p.splits; ++split) {
        const int64_t t = (split * rows + row) * HD + col;
        const float2 pk = *reinterpret_cast<const float2*>(dk_part + t);
        const float2 pv = *reinterpret_cast<const float2*>(dv_part + t);
        gk.x += pk.x;
        gk.y += pk.y;
        gv.x += pv.x;
        gv.y += pv.y;
      }
      gk = make_float2(gk.x * kLn2, gk.y * kLn2);
      if (p.rope_cos != nullptr) {
        const int64_t t = n * p.rope_sn + (int64_t)s * HD + col;
        gk = rope_bwd_pair(gk.x, gk.y, p.rope_cos + t, p.rope_sin + t);
      }
    }
    *reinterpret_cast<uint32_t*>(static_cast<T*>(p.dk) + b * p.dk_sb + n * p.dk_sn + s * p.dk_ss + col) =
        Ops<T>::pack(gk.x, gk.y);
    *reinterpret_cast<uint32_t*>(static_cast<T*>(p.dv) + b * p.dv_sb + n * p.dv_sn + s * p.dv_ss + col) =
        Ops<T>::pack(gv.x, gv.y);
  }
}

// Byte offsets in K3's shared memory: the q_s and dO tiles, kDqStages k_r tiles,
// kDqStages v tiles, then the barriers q_full, full[kDqStages], empty[kDqStages].
template <int HD>
struct DqLayout {
  static constexpr int kTileBytes = HD / 64 * kHalf;  // 128 rows
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTileBytes;
  static constexpr int kK = kDo + kTileBytes;
  static constexpr int kV = kK + kDqStages * kTileBytes;
  static constexpr int kBars = kV + kDqStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDqStages);
};

// K3's producer, one thread: q_s and dO once, then k_r and v tile t into stage
// t % kDqStages once the consumers have released it.
template <int HD>
__device__ __forceinline__ void dq_produce(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                           const CUtensorMap* v_map, const CUtensorMap* do_map, uint32_t base, int q0,
                                           int n, int b, int num_tiles) {
  using L = DqLayout<HD>;
  const uint32_t q_full = base + L::kBars;
  mbar_expect_tx(q_full, 2 * L::kTileBytes);
#pragma unroll
  for (int h = 0; h < HD / 64; ++h) {
    tma_load(base + L::kQ + h * kHalf, q_map, q_full, h * 64, q0, n, b);
    tma_load(base + L::kDo + h * kHalf, do_map, q_full, h * 64, q0, n, b);
  }
  for (int t = 0; t < num_tiles; ++t) {
    const int st = t % kDqStages;
    const uint32_t full = q_full + 8 * (1 + st), empty = full + 8 * kDqStages;
    mbar_wait(empty, ((t / kDqStages) & 1) ^ 1);
    mbar_expect_tx(full, 2 * L::kTileBytes);
#pragma unroll
    for (int h = 0; h < HD / 64; ++h) {
      tma_load(base + L::kK + st * L::kTileBytes + h * kHalf, k_map, full, h * 64, t * kBlockKv, n, b);
      tma_load(base + L::kV + st * L::kTileBytes + h * kHalf, v_map, full, h * 64, t * kBlockKv, n, b);
    }
  }
}

// A consumer warpgroup of K3 owning q rows q0 + 64*cwg ...; each thread holds
// rows row0 = q0 + 64*cwg + 16*warp + lane/4 and row0 + 8 (accumulator layout
// as in K2, columns being keys of s and H columns of dq).
template <typename T, int HD>
__device__ __forceinline__ void dq_consume(const BwdParams& p, uint32_t base, int cwg, int q0, int n, int b,
                                           int kv_len, int num_tiles) {
  using L = DqLayout<HD>;
  constexpr int kAcc = HD / 2;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t q_full = base + L::kBars;
  const int row0 = q0 + 64 * cwg + 16 * warp + lane / 4;
  float lse2[2], dl[2];  // base-2 LSE and delta of this thread's rows (0 past Sq: never stored)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const int64_t at = ((int64_t)b * p.heads + n) * p.seq_q + row;
    lse2[r] = row < p.seq_q ? p.lse[at] * kLog2e : 0.f;
    dl[r] = row < p.seq_q ? p.delta[at] : 0.f;
  }
  const uint32_t q_addr = base + L::kQ + cwg * 64 * 128, do_addr = base + L::kDo + cwg * 64 * 128;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  uint32_t pk[kBlockKv / 16][4], da[kBlockKv / 16][4];  // p, then ds (the A operand), rounded to T and packed
  const int c = 2 * (lane % 4);
  mbar_wait(q_full, 0);
  for (int t = 0; t < num_tiles; ++t) {
    const int st = t % kDqStages;
    const uint32_t full = q_full + 8 * (1 + st);
    const uint32_t k_addr = base + L::kK + st * L::kTileBytes, v_addr = base + L::kV + st * L::kTileBytes;
    const int k0 = t * kBlockKv;
    const bool all_valid = k0 + kBlockKv <= kv_len;
    // Element pair (8kk + 2e, +1) of a fragment: q row row0 + 8*(e & 1), keys k0 + 8j + c and + 1.
    auto valid = [&](int kk, int e, int dk) { return all_valid || k0 + 8 * (2 * kk + (e >> 1)) + c + dk < kv_len; };
    mbar_wait(full, (t / kDqStages) & 1);

    float s[64], dp[64];
    wgmma_fence();
    issue_ss<T, HD, kBlockKv, kHalf, kHalf>(s, q_addr, k_addr);  // s = q_s k_r^T
    wgmma_commit();
    issue_ss<T, HD, kBlockKv, kHalf, kHalf>(dp, do_addr, v_addr);  // dp = dO v^T
    wgmma_commit();
    // s has landed, and so has the previous tile's dq group: its stage is free.
    wgmma_wait_one();
    fence_regs<64>(s);
    if (t > 0) {
      fence_regs<kAcc>(acc);
      fence_regs<kBlockKv / 16>(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(q_full + 8 * (1 + kDqStages + (t - 1) % kDqStages));
    }
#pragma unroll
    for (int kk = 0; kk < kBlockKv / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 8 * kk + 2 * e;
        const float p0 = fast_exp2(s[x] - lse2[e & 1]), p1 = fast_exp2(s[x + 1] - lse2[e & 1]);
        pk[kk][e] = Ops<T>::pack(valid(kk, e, 0) ? p0 : 0.f, valid(kk, e, 1) ? p1 : 0.f);
      }
    }
    wgmma_wait_all();
    fence_regs<64>(dp);
#pragma unroll
    for (int kk = 0; kk < kBlockKv / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 8 * kk + 2 * e;
        const float2 pv = Ops<T>::unpack(pk[kk][e]);
        const float2 d = round_pair<T>(dp[x] - dl[e & 1], dp[x + 1] - dl[e & 1]);
        da[kk][e] = Ops<T>::pack(valid(kk, e, 0) ? pv.x * d.x : 0.f, valid(kk, e, 1) ? pv.y * d.y : 0.f);
      }
    }
    fence_regs<kAcc>(acc);
    wgmma_fence();
    issue_rs<T, HD, kBlockKv, kHalf>(acc, da, k_addr);  // dq += ds k_r
    wgmma_commit();  // waited for after the next tile's s is issued
  }
  wgmma_wait_all();
  fence_regs<kAcc>(acc);
  fence_regs<kBlockKv / 16>(da);

  // ds lacked the softmax scale (it was folded into q_s): apply it, then the
  // transpose rotation with q's rows.
  T* dq = static_cast<T*>(p.dk) + b * p.dk_sb + n * p.dk_sn;
  const float* cos = p.rope_cos != nullptr ? p.rope_cos + n * p.rope_sn : nullptr;
  const float* sin = p.rope_sin != nullptr ? p.rope_sin + n * p.rope_sn : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.seq_q) continue;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      float2 g = make_float2(acc[4 * i + 2 * r] * p.scale, acc[4 * i + 2 * r + 1] * p.scale);
      if (cos != nullptr) {
        const int64_t t = (int64_t)row * HD + col;
        g = rope_bwd_pair(g.x, g.y, cos + t, sin + t);
      }
      *reinterpret_cast<uint32_t*>(dq + row * p.dk_ss + col) = Ops<T>::pack(g.x, g.y);
    }
  }
}

// K3: one CTA per (q tile of kBlockRows rows, head, batch); loops over kv tiles
// up to kv_lens[b].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                       const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + DqLayout<HD>::kBars;
  const int q0 = blockIdx.x * kBlockRows, n = blockIdx.y, b = blockIdx.z;
  const int num_tiles = (kv_length(p, b) + kBlockKv - 1) / kBlockKv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(q_full + 8 * (1 + st), 1);                          // full
      mbar_init(q_full + 8 * (1 + kDqStages + st), 4 * kConsumers);  // empty: one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) dq_produce<HD>(&q_map, &k_map, &v_map, &do_map, base, q0, n, b, num_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dq_consume<T, HD>(p, base, threadIdx.x / 128 - 1, q0, n, b, kv_length(p, b), num_tiles);
  }
}

// The four operands' tensor maps: q_s and dO in boxes of q_rows rows, k_r and v
// in boxes of kv_rows rows. strides: q_s, k_r, v, dO, each (batch, head, seq).
bool encode_maps(CUtensorMap* maps, const void* q_s, const void* k_r, const void* v, const void* dout, int dtype,
                 int batch, int heads, int seq_q, int seq_kv, int head_dim, int q_rows, int kv_rows,
                 const int64_t* strides) {
  return encode_operand(&maps[0], q_s, dtype, head_dim, seq_q, heads, batch, q_rows, strides[0], strides[1],
                        strides[2]) &&
         encode_operand(&maps[1], k_r, dtype, head_dim, seq_kv, heads, batch, kv_rows, strides[3], strides[4],
                        strides[5]) &&
         encode_operand(&maps[2], v, dtype, head_dim, seq_kv, heads, batch, kv_rows, strides[6], strides[7],
                        strides[8]) &&
         encode_operand(&maps[3], dout, dtype, head_dim, seq_q, heads, batch, q_rows, strides[9], strides[10],
                        strides[11]);
}

BwdParams make_params(const void* lse, const void* delta, const void* kv_lens, const void* rope_cos,
                      const void* rope_sin, int batch, int heads, int seq_q, int seq_kv, int64_t rope_sn) {
  BwdParams p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.batch = batch;
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.splits = 1;
  p.rope_sn = rope_sn;
  return p;
}

template <typename T, int HD>
cudaError_t launch_dkdv(const CUtensorMap* maps, const BwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.seq_kv + kBlockRows - 1) / kBlockRows, p.heads, p.batch * p.splits);
  static std::atomic<uint64_t> attribute_set{0};
  return launch_sm90(bwd_dkdv_sm90_kernel<T, HD>, attribute_set, grid, kThreads, DkdvLayout<HD>::kBytes + 1024,
                     stream, maps[0], maps[1], maps[2], maps[3], p);
}

template <typename T, int HD>
cudaError_t launch_dq(const CUtensorMap* maps, const BwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.seq_q + kBlockRows - 1) / kBlockRows, p.heads, p.batch);
  static std::atomic<uint64_t> attribute_set{0};
  return launch_sm90(bwd_dq_sm90_kernel<T, HD>, attribute_set, grid, kThreads, DqLayout<HD>::kBytes + 1024, stream,
                     maps[0], maps[1], maps[2], maps[3], p);
}

template <typename T, int HD>
cudaError_t launch_reduce(const float* dk_part, const float* dv_part, const BwdParams& p, cudaStream_t stream) {
  const int64_t blocks = ((int64_t)p.batch * p.heads * p.seq_kv * (HD / 2) + 255) / 256;
  dkdv_reduce_kernel<T, HD><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(dk_part, dv_part, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. q_s and k_r are the pre-pass's
// operands (k itself when there are no RoPE tables); dtype: 0 = bf16, 1 = fp16;
// strides in elements, the head dim contiguous and every operand 16-byte
// aligned. Each returns a cudaError_t (cudaErrorInvalidValue also when a
// tensor map cannot be encoded).

// K2. strides: q_s, k_r, v, dO, dk, dv, each (batch, head, seq). With splits >
// 1 each of `splits` CTAs per kv tile takes q_tiles_per_split q tiles of
// kBlockQ rows and writes fp32 partial dk and dv into `partials` (2 x splits x
// B x N x Skv x H floats), and the reduce pass then writes dk and dv from them;
// with splits == 1 `partials` is unused.
extern "C" int flash_bwd_dkdv_sm90(const void* q_s, const void* k_r, const void* v, const void* dout,
                                   const void* lse, const void* delta, const void* kv_lens, const void* rope_cos,
                                   const void* rope_sin, void* dk, void* dv, void* partials, int batch, int heads,
                                   int seq_q, int seq_kv, int head_dim, int dtype, const int64_t* strides,
                                   int64_t rope_sn, int splits, int q_tiles_per_split, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1) || splits < 1 || q_tiles_per_split < 1 ||
      (splits > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!encode_maps(maps, q_s, k_r, v, dout, dtype, batch, heads, seq_q, seq_kv, head_dim, kBlockQ, kBlockRows,
                   strides))
    return cudaErrorInvalidValue;
  BwdParams p = make_params(lse, delta, kv_lens, rope_cos, rope_sin, batch, heads, seq_q, seq_kv, rope_sn);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = strides[12]; p.dk_sn = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sn = strides[16]; p.dv_ss = strides[17];
  BwdParams k2 = p;  // K2 writes dk and dv, or with splits > 1 the partials
  k2.splits = splits;
  k2.q_tiles_per_split = q_tiles_per_split;
  const float* dk_part = static_cast<const float*>(partials);
  const float* dv_part = dk_part + (int64_t)splits * batch * heads * seq_kv * head_dim;
  if (splits > 1) {
    k2.dk = const_cast<float*>(dk_part);
    k2.dv = const_cast<float*>(dv_part);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && head_dim == 64) err = launch_dkdv<__nv_bfloat16, 64>(maps, k2, s);
  else if (dtype == 0) err = launch_dkdv<__nv_bfloat16, 128>(maps, k2, s);
  else if (head_dim == 64) err = launch_dkdv<__half, 64>(maps, k2, s);
  else err = launch_dkdv<__half, 128>(maps, k2, s);
  if (err != cudaSuccess || splits == 1) return err;
  p.splits = splits;
  if (dtype == 0 && head_dim == 64) return launch_reduce<__nv_bfloat16, 64>(dk_part, dv_part, p, s);
  if (dtype == 0) return launch_reduce<__nv_bfloat16, 128>(dk_part, dv_part, p, s);
  if (head_dim == 64) return launch_reduce<__half, 64>(dk_part, dv_part, p, s);
  return launch_reduce<__half, 128>(dk_part, dv_part, p, s);
}

// K3. strides: q_s, k_r, v, dO, dq, each (batch, head, seq).
extern "C" int flash_bwd_dq_sm90(const void* q_s, const void* k_r, const void* v, const void* dout, const void* lse,
                                 const void* delta, const void* kv_lens, const void* rope_cos, const void* rope_sin,
                                 void* dq, int batch, int heads, int seq_q, int seq_kv, int head_dim, int dtype,
                                 const int64_t* strides, int64_t rope_sn, float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!encode_maps(maps, q_s, k_r, v, dout, dtype, batch, heads, seq_q, seq_kv, head_dim, kBlockRows, kBlockKv,
                   strides))
    return cudaErrorInvalidValue;
  BwdParams p = make_params(lse, delta, kv_lens, rope_cos, rope_sin, batch, heads, seq_q, seq_kv, rope_sn);
  p.dk = dq;
  p.dk_sb = strides[12]; p.dk_sn = strides[13]; p.dk_ss = strides[14];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_dq<__nv_bfloat16, 64>(maps, p, s);
  if (dtype == 0) return launch_dq<__nv_bfloat16, 128>(maps, p, s);
  if (head_dim == 64) return launch_dq<__half, 64>(maps, p, s);
  return launch_dq<__half, 128>(maps, p, s);
}
