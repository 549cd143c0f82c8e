// Flash attention backward for Hopper (sm_90a), CUDA C++: K2 (dk, dv), K3 (dq)
// and K5 (dq, dk and dv in one sweep) as warp-specialised kernels whose
// products all run on wgmma, fed by TMA through rings of shared-memory stages.
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_bwd_dkdv_kernel (K2, :888),
// ::_bwd_dq_kernel (K3, :1199) and ::_bwd_fused_kernel (K5, :1038; picked there
// by FINETRAINERS_FLASH_FUSED_BWD) (Pallas, TPU), driven there by
// _flash_backward through pallas_call (:1470, :1502, :1434). They compute those
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
// no valid key gets dq = 0. K5 computes K2's and K3's functions with s, p, dp
// and ds formed once per (kv tile, q tile) pair instead of twice, adding each
// q tile's ds k_r into an fp32 (B, N, Sq, H) accumulator that the caller
// zeroes; `dq_emit_kernel` (flash_bwd.cu) then scales, rotates and casts it.
//
// What bounds them on this card: at Wan's training shape (B=1, N=12,
// S=19,968, H=128) K2 does four products, 8*N*Sq*Skv*H = 4.90 TFLOP, K3
// three, 3.67 TFLOP, and K5 five, 6.12 TFLOP, against ~0.4 GB of q_s, k_r, v,
// dO, LSE, delta, tables and gradients (K5 adds the 123 MB fp32 accumulator):
// over 10,000 operations per byte, far above the H100's ~295 FLOP/byte ridge.
// So all three are bound by operations (4.95, 3.72 and 6.19 ms at the bf16
// peak), and the tensor cores are the resource to feed. With cross-attention
// over 128-512 keys the products shrink 40-150-fold and K2 and K5 run out of
// kv tiles to spread over 132 SMs.
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
//  - K5 is K2's kernel (producer, ring, kv-major products, split q loop for
//    cross-attention) with a fifth product per q tile: dq (64 q x H) = ds k_r.
//    kv is its contraction dim, and ds^T lies kv-major in registers, so each
//    warpgroup stores its ds^T rows into a 128 x 64 tile of shared memory in
//    the 128-byte swizzle (two such tiles, used in turn), which the product
//    reads as an MN-major A operand beside the resident k_r (MN-major B). At
//    H=128 the two warpgroups meet at a named barrier per q tile and each
//    takes 64 of dq's columns over all 128 keys; at H=64 each takes its own 64
//    keys over all 64 columns, with no barrier, and both add. Either way a
//    warpgroup holds a 64 x 64 fp32 dq tile (32 registers): it is issued
//    before dk += ds^T q_s and waited for with dv, so the dk product runs
//    while the tile goes into the fp32 accumulator in device memory: each warp
//    stores its 16 rows into a staging slice of shared memory and one lane
//    issues TMA reduces (`.add.f32`), 32 KB per q tile and CTA into L2, which
//    measured faster than vector reductions (red.global.add.v2.f32) from the
//    registers. Unlike K2, K5
//    waits for dv within its tile, so only dk and ds^T stay live into the next
//    tile's score products (208 registers at the peak; K2's 224, with p^T
//    live too, would leave no room for the dq tile). Rows of k_r past
//    kv_lens[b] are zeroed in shared memory once, since ds (0 there)
//    multiplies them in the dq product.
//  - TMA reads the real rows of k and v between kv_lens[b] and Skv (and fills
//    rows past S with 0): p and ds there are selected to 0, so they add
//    nothing, whatever those rows hold.
// Tried and left out: ordering the two warpgroups' score products with named
// barriers (ping-pong) measured 2% slower for K2 and 17% for K3. For K5:
// holding each dq tile in registers through the next tile's score products
// (it spills), and dk += ds^T q_s read from the ds^T tile in shared memory
// (slower). tools/torch_k5_k7a_variants.py times the choices kept against
// their alternatives. Not yet used: a persistent grid, TMA stores of the
// gradients.

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
  float* dq_acc;  // K5: the fp32 (B, N, Sq, H) contiguous dq accumulator
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

// Byte offsets in K2's and K5's shared memory (from a 1024-byte aligned base):
// the k_r and v tiles, kDkdvStages q_s and dO tiles, K5's two ds^T tiles,
// kDkdvStages rows of base-2 LSE and of delta, then the barriers kv_full,
// full[kDkdvStages], empty[kDkdvStages]. At H=128 K5 takes 226 of the 227 KB.
template <int HD, bool FUSED>
struct DkdvLayout {
  static constexpr int kBq = kBlockQ;
  static constexpr int kKvBytes = HD / 64 * kHalf;
  static constexpr int kQHalf = kBq * 128;  // a 64-column half of a q_s or dO tile
  static constexpr int kQBytes = HD / 64 * kQHalf;
  static constexpr int kDsBytes = kBlockRows * kBq * 2;  // ds^T: 128 kv rows of 64 q columns
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBytes;
  static constexpr int kQ = kV + kKvBytes;
  static constexpr int kDo = kQ + kDkdvStages * kQBytes;
  static constexpr int kDs = kDo + kDkdvStages * kQBytes;
  // K5's fp32 dq staging for the TMA reduces: per warpgroup two boxes of 64 q rows x 32 columns.
  static constexpr int kDqStageBytes = 64 * 64 * 4;
  static constexpr int kDqStage = kDs + (FUSED ? 2 * kDsBytes : 0);
  static constexpr int kLse = kDqStage + (FUSED ? kConsumers * kDqStageBytes : 0);
  static constexpr int kDelta = kLse + kDkdvStages * kBq * 4;
  static constexpr int kBars = kDelta + kDkdvStages * kBq * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDkdvStages);
};

// K2's and K5's producer, warp 0: k_r and v once, then q tile t0 + i into
// stage i % kDkdvStages once the consumers have released it. Lane 0 issues the
// TMA loads; every lane stages the tile's base-2 LSE and delta (0 past Sq). A
// full barrier completes on lane 0's expect-tx arrival, the 32 lanes' arrivals
// after their stores, and the TMA bytes.
template <int HD, bool FUSED>
__device__ __forceinline__ void dkdv_produce(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                             const CUtensorMap* v_map, const CUtensorMap* do_map, const BwdParams& p,
                                             uint32_t base, unsigned char* smem, int kv0, int n, int b, int t0,
                                             int num_tiles) {
  using L = DkdvLayout<HD, FUSED>;
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

// The fragments of K2's and K5's consumers: each thread holds two kv rows,
// row0 and row0 + 8, in the wgmma accumulator layout; element pair (8kk + 2e,
// +1) of a 64 x kBlockQ score fragment is kv row row0 + 8*(e & 1), q columns
// 8*(2kk + (e >> 1)) + c and + 1 of the tile, c = 2*(lane % 4). `valid(kk, e,
// d)` says whether column d of that pair is a valid (key, q row) pair.
//
// p^T = T(exp2(s^T - lse * log2e)), selected to 0 where invalid, packed as the
// A operand of dv += p^T dO.
template <typename T, typename Valid>
__device__ __forceinline__ void dkdv_p(uint32_t (*pa)[4], const float* s, const float* lse2, int c, Valid valid) {
#pragma unroll
  for (int kk = 0; kk < kBlockQ / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 8 * kk + 2 * e;
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * (2 * kk + (e >> 1)) + c);
      const float p0 = fast_exp2(s[x] - l2.x), p1 = fast_exp2(s[x + 1] - l2.y);
      pa[kk][e] = Ops<T>::pack(valid(kk, e, 0) ? p0 : 0.f, valid(kk, e, 1) ? p1 : 0.f);
    }
  }
}

// ds^T = T(p^T * T(dp^T - delta)), selected to 0 where p is, packed as the A
// operand of dk += ds^T q_s.
template <typename T, typename Valid>
__device__ __forceinline__ void dkdv_ds(uint32_t (*da)[4], const uint32_t (*pa)[4], const float* dp,
                                        const float* delta, int c, Valid valid) {
#pragma unroll
  for (int kk = 0; kk < kBlockQ / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 8 * kk + 2 * e;
      const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * (2 * kk + (e >> 1)) + c);
      const float2 pv = Ops<T>::unpack(pa[kk][e]);
      const float2 d = round_pair<T>(dp[x] - d2.x, dp[x + 1] - d2.y);
      da[kk][e] = Ops<T>::pack(valid(kk, e, 0) ? pv.x * d.x : 0.f, valid(kk, e, 1) ? pv.y * d.y : 0.f);
    }
  }
}

// A consumer warpgroup's dk and dv (rows row0, row0 + 8 of each fragment):
// with one split, T(rope^T(ln2 * dk)) with k's tables and T(dv) into the
// outputs; else the fp32 partials of split `split`.
template <typename T, int HD>
__device__ __forceinline__ void dkdv_store(const BwdParams& p, const float* dk, const float* dv, int row0, int n,
                                           int b, int split) {
  const int lane = threadIdx.x % 32;
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

// A consumer warpgroup of K2 (`cwg` 0 or 1) owning kv rows kv0 + 64*cwg ...
// Each thread holds two kv rows, row0 = kv0 + 64*cwg + 16*warp + lane/4 and
// row0 + 8, in the wgmma accumulator layout: element 4j+e of a fragment is at
// column 8j + 2*(lane%4) + (e&1) (a q row of s^T, an H column of dk/dv) of row
// row0 + 8*(e>>1).
template <typename T, int HD>
__device__ __forceinline__ void dkdv_consume(const BwdParams& p, uint32_t base, const unsigned char* smem, int cwg,
                                             int kv0, int n, int b, int split, int t0, int num_tiles, int kv_len) {
  using L = DkdvLayout<HD, false>;
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
    dkdv_p<T>(pa, s, lse2, c, valid);
    fence_regs<kAcc>(dv);
    wgmma_fence();
    issue_rs<T, HD, kBq, L::kQHalf>(dv, pa, do_addr);  // dv += p^T dO, running while ds is computed
    wgmma_commit();
    wgmma_wait_one();  // dp^T has landed
    fence_regs<kS>(dp);
    dkdv_ds<T>(da, pa, dp, delta, c, valid);
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
  dkdv_store<T, HD>(p, dk, dv, row0, n, b, split);
}

// The named barrier at which K5's consumer warpgroups meet per q tile: at
// H=128 both (they share the ds^T tile), at H=64 each alone.
template <int HD>
__device__ __forceinline__ void fused_barrier(int cwg) {
  if constexpr (HD == 128) {
    named_barrier_sync(1, 256);
  } else {
    named_barrier_sync(2 + cwg, 128);
  }
}

// Add a warp's staged 16 rows of the dq tile at q0 into the accumulator: one
// lane issues two TMA reduces (16 rows x 32 columns each) after the warp's
// stores are fenced for the async proxy.
template <int HD>
__device__ __forceinline__ void reduce_dq_rows(const CUtensorMap* dq_map, uint32_t slice, int cwg, int q0,
                                               const BwdParams& p) {
  const int warp = (threadIdx.x % 128) / 32;
  fence_proxy_async();
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    const int dq_col0 = HD == 128 ? 64 * cwg : 0;
    const int n = blockIdx.y, b = blockIdx.z / p.splits;
    tma_reduce_add(dq_map, slice, dq_col0, q0 + 16 * warp, n, b);
    tma_reduce_add(dq_map, slice + 8192, dq_col0 + 32, q0 + 16 * warp, n, b);
    bulk_commit();
  }
}

// One q tile i of K5's consumer warpgroup (K2's consumer's rows, fragments and
// q loop, with the dq product): s^T and dp^T issued; p^T, then dv += p^T dO
// issued; ds^T; ds^T stored into ds^T tile i % 2; then dq = ds k_r and dk +=
// ds^T q_s issued; dv and dq waited for, and the dq tile added into the
// accumulator while dk runs. At H=128 (kSplitH) the warpgroups share one ds^T
// tile: both store, meet at named barrier 1, and warpgroup w takes dq's
// columns 64w.. over all 128 keys; at H=64 warpgroup w takes its own 64 keys
// (its half of the tile) over all 64 columns. The tile is written again two q
// tiles later, after each warpgroup has waited for the dq product that read it
// (at H=128, after the next tile's barrier, which both pass only then). Each
// warp adds its 16 rows of the dq tile through its slice of the staging tile:
// its lanes store them at the end of tile i, and reduce_dq_rows adds them
// once tile i+1's score products are issued (after the loop for the last
// tile), so the fence and the reduces' issue overlap those products. Before
// the barrier, lane 0 waits until its previous
// reduces have read the slice. MASK: p and ds of keys at or past kv_len (this
// thread's first row is valid while rows_valid > 0) and of q rows past Sq are
// selected to 0; without MASK the tile has neither, and no select is compiled.
template <typename T, int HD, bool MASK>
__device__ __forceinline__ void fused_tile(const CUtensorMap* dq_map, const BwdParams& p, uint32_t base, int cwg,
                                           int i, int q0, int rows_valid, float* dk, float* dv, uint32_t (*pa)[4],
                                           uint32_t (*da)[4]) {
  using L = DkdvLayout<HD, true>;
  constexpr int kBq = L::kBq;
  constexpr int kS = kBq / 2;
  constexpr int kAcc = HD / 2;
  constexpr bool kSplitH = HD == 128;
  constexpr int kDqKeys = kSplitH ? kBlockRows : 64;  // the dq product's contraction rows
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int c = 2 * (lane % 4);
  const uint32_t kv_full = base + L::kBars;
  const int st = i % kDkdvStages;
  const uint32_t q_addr = base + L::kQ + st * L::kQBytes, do_addr = base + L::kDo + st * L::kQBytes;
  auto valid = [&](int kk, int e, int d) {
    if constexpr (MASK) {
      return 8 * (e & 1) < rows_valid && q0 + 8 * (2 * kk + (e >> 1)) + c + d < p.seq_q;
    } else {
      return true;
    }
  };
  mbar_wait(kv_full + 8 * (1 + st), (i / kDkdvStages) & 1);

  float s[kS], dp[kS];
  wgmma_fence();
  issue_ss<T, HD, kBq, kHalf, L::kQHalf>(s, base + L::kK + cwg * 64 * 128, q_addr);  // s^T = k_r q_s^T
  wgmma_commit();
  issue_ss<T, HD, kBq, kHalf, L::kQHalf>(dp, base + L::kV + cwg * 64 * 128, do_addr);  // dp^T = v dO^T
  wgmma_commit();
  // This warp's slice of the staging tile (two boxes of 64 rows x 32 fp32 columns, 128-byte rows with
  // TMA's 128-byte swizzle): its 16 rows from 16*warp.
  const uint32_t slice = base + L::kDqStage + cwg * L::kDqStageBytes + 16 * warp * 128;
  if (i > 0) reduce_dq_rows<HD>(dq_map, slice, cwg, q0 - kBq, p);  // the previous tile's dq rows
  // s^T has landed, and so has the previous tile's dk product: that tile's stage is free.
  wgmma_wait_one();
  fence_regs<kS>(s);
  if (i > 0) {
    fence_regs<kAcc>(dk);
    fence_regs<kBq / 16>(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_full + 8 * (1 + kDkdvStages + (i - 1) % kDkdvStages));
  }
  const float* lse2 = reinterpret_cast<const float*>(__cvta_shared_to_generic(base + L::kLse)) + st * kBq;
  dkdv_p<T>(pa, s, lse2, c, valid);
  fence_regs<kAcc>(dv);
  wgmma_fence();
  issue_rs<T, HD, kBq, L::kQHalf>(dv, pa, do_addr);  // dv += p^T dO
  wgmma_commit();
  wgmma_wait_one();  // dp^T has landed
  fence_regs<kS>(dp);
  const float* delta = reinterpret_cast<const float*>(__cvta_shared_to_generic(base + L::kDelta)) + st * kBq;
  dkdv_ds<T>(da, pa, dp, delta, c, valid);

  // ds^T into tile i % 2: this thread's 4-byte slots of rows 64*cwg + 16*warp + lane/4 (+ 8), q columns
  // 8m + c, + 1 in 16-byte chunk m, placed at chunk m ^ (row % 8) by the 128-byte swizzle.
  const uint32_t ds_tile = base + L::kDs + (i % 2) * L::kDsBytes;
#pragma unroll
  for (int kk = 0; kk < kBq / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st_shared(ds_tile + (64 * cwg + 16 * warp + lane / 4 + 8 * (e & 1)) * 128 + 4 * (lane % 4) +
                    (((2 * kk + (e >> 1)) ^ (lane / 4)) << 4),
                da[kk][e]);
  }
  fence_proxy_async();
  if (lane == 0) bulk_wait_read();  // the previous tile's reduces have read this warp's staging slice
  fused_barrier<HD>(cwg);

  // dq = ds k_r: A = ds (q rows x keys) from the ds^T tile, B = k_r (keys x 64 columns), both MN-major.
  float dq[32];
  const uint64_t dq_a = mnmajor_desc(ds_tile + (kSplitH ? 0 : cwg * 64 * 128), kHalf);
  const uint64_t dq_b = mnmajor_desc(base + L::kK + (kSplitH ? cwg * kHalf : cwg * 64 * 128), kHalf);
  fence_regs<kAcc>(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDqKeys / 16; ++kk)
    Wgmma<T>::ss64_mn(dq, dq_a + mnmajor_step(kk), dq_b + mnmajor_step(kk), kk);
  wgmma_commit();
  issue_rs<T, HD, kBq, L::kQHalf>(dk, da, q_addr);  // dk += ds^T q_s
  wgmma_commit();
  wgmma_wait_one();  // dv and dq have landed; dk runs on
  fence_regs<32>(dq);
  fence_regs<kAcc>(dv);
  fence_regs<kBq / 16>(pa);
  // Rows 16*warp + lane/4 (+ 8) of the staging slice; columns 8j + c, + 1 in box j / 4, chunk
  // 2*(j % 4) + c / 4, at byte 8*(lane & 1) of it.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int chunk = 2 * (j % 4) + (lane % 4) / 2;
      st_shared(slice + (lane / 4 + 8 * r) * 128 + (j / 4) * 8192 + ((chunk ^ (lane / 4)) << 4) + 8 * (lane & 1),
                dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// A consumer warpgroup of K5: its q loop over fused_tile. At H=64 the tiles
// that need no select take the unmasked instantiation, which is faster there;
// at H=128 every tile takes the masked one, whose selects cost less than a
// second copy of the loop body. The CTA's coordinates are read again from
// blockIdx where they are needed, not held through the loop (a spill at H=128
// went with that).
template <typename T, int HD>
__device__ __forceinline__ void fused_consume(const CUtensorMap* dq_map, const BwdParams& p, uint32_t base,
                                              int cwg, int t0, int num_tiles, int kv_len) {
  using L = DkdvLayout<HD, true>;
  constexpr int kBq = L::kBq;
  constexpr int kAcc = HD / 2;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int kv0 = blockIdx.x * kBlockRows;
  const int rows_valid = kv_len - (kv0 + 64 * cwg + 16 * warp + lane / 4);  // this thread's first row: valid if > 0
  const bool rows_all_valid = kv0 + kBlockRows <= kv_len;

  float dk[kAcc], dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[kBq / 16][4], da[kBq / 16][4];  // p^T and ds^T, rounded to T and packed: the A operands
  mbar_wait(base + L::kBars, 0);
  if (!rows_all_valid) {  // keys past kv_len: ds is 0 there, but 0 * NaN is not
    unsigned char* smem = reinterpret_cast<unsigned char*>(__cvta_shared_to_generic(base));
    zero_tile_rows<HD, kHalf>(smem + L::kK, max(kv_len - kv0, 64 * cwg), 64 * cwg + 64, threadIdx.x % 128, 128);
    fence_proxy_async();
    fused_barrier<HD>(cwg);
  }
  for (int i = 0; i < num_tiles; ++i) {
    const int q0 = (t0 + i) * kBq;
    if (HD == 64 && rows_all_valid && q0 + kBq <= p.seq_q) {
      fused_tile<T, HD, false>(dq_map, p, base, cwg, i, q0, rows_valid, dk, dv, pa, da);
    } else {
      fused_tile<T, HD, true>(dq_map, p, base, cwg, i, q0, rows_valid, dk, dv, pa, da);
    }
  }
  if (num_tiles > 0)  // the last tile's dq rows
    reduce_dq_rows<HD>(dq_map, base + L::kDqStage + cwg * L::kDqStageBytes + 16 * warp * 128, cwg,
                       (t0 + num_tiles - 1) * kBq, p);
  wgmma_wait_all();
  fence_regs<kAcc>(dk);
  fence_regs<kBq / 16>(da);
  if (lane == 0) bulk_wait_read();
  dkdv_store<T, HD>(p, dk, dv, kv0 + 64 * cwg + 16 * warp + lane / 4, blockIdx.y, blockIdx.z / p.splits,
                    blockIdx.z % p.splits);
}

// K2 (FUSED false) and K5: one CTA per (kv tile of kBlockRows rows, head,
// batch x split); split s takes q tiles [s * q_tiles_per_split, (s + 1) *
// q_tiles_per_split).
template <typename T, int HD, bool FUSED>
__device__ __forceinline__ void dkdv_cta(const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
                                         const CUtensorMap* do_map, const CUtensorMap* dq_map, const BwdParams& p,
                                         unsigned char* smem_raw) {
  using L = DkdvLayout<HD, FUSED>;
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
    if (threadIdx.x < 32)
      dkdv_produce<HD, FUSED>(q_map, k_map, v_map, do_map, p, base, smem, kv0, n, b, t0, num_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if constexpr (FUSED) {
      fused_consume<T, HD>(dq_map, p, base, threadIdx.x / 128 - 1, t0, num_tiles, kv_len);
    } else {
      dkdv_consume<T, HD>(p, base, smem, threadIdx.x / 128 - 1, kv0, n, b, split, t0, num_tiles, kv_len);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                         const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  dkdv_cta<T, HD, false>(&q_map, &k_map, &v_map, &do_map, nullptr, p, smem_raw);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_fused_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dq_map, const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  dkdv_cta<T, HD, true>(&q_map, &k_map, &v_map, &do_map, &dq_map, p, smem_raw);
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

// K2, or with FUSED K5.
template <typename T, int HD, bool FUSED>
cudaError_t launch_dkdv(const CUtensorMap* maps, const BwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.seq_kv + kBlockRows - 1) / kBlockRows, p.heads, p.batch * p.splits);
  static std::atomic<uint64_t> attribute_set{0};
  if constexpr (FUSED) {
    return launch_sm90(bwd_fused_sm90_kernel<T, HD>, attribute_set, grid, kThreads,
                       DkdvLayout<HD, true>::kBytes + 1024, stream, maps[0], maps[1], maps[2], maps[3], maps[4], p);
  } else {
    return launch_sm90(bwd_dkdv_sm90_kernel<T, HD>, attribute_set, grid, kThreads,
                       DkdvLayout<HD, false>::kBytes + 1024, stream, maps[0], maps[1], maps[2], maps[3], p);
  }
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

// K2 and K5's shared host path: the maps, K2 or K5 (writing dk and dv, or with
// splits > 1 the fp32 partials), then the reduce pass where the q loop is split.
template <bool FUSED>
int dkdv_entry(const void* q_s, const void* k_r, const void* v, const void* dout, const void* lse, const void* delta,
               const void* kv_lens, const void* rope_cos, const void* rope_sin, void* dk, void* dv, void* partials,
               float* dq_acc, int batch, int heads, int seq_q, int seq_kv, int head_dim, int dtype,
               const int64_t* strides, int64_t rope_sn, int splits, int q_tiles_per_split, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1) || splits < 1 || q_tiles_per_split < 1 ||
      (splits > 1 && partials == nullptr) || (FUSED && dq_acc == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap maps[5];
  if (!encode_maps(maps, q_s, k_r, v, dout, dtype, batch, heads, seq_q, seq_kv, head_dim, kBlockQ, kBlockRows,
                   strides))
    return cudaErrorInvalidValue;
  // K5's dq accumulator (B, N, Sq, H) fp32 contiguous, in boxes of a warp's 16 q rows x 32 columns (128 bytes).
  if (FUSED && !encode_map(&maps[4], dq_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 32, CU_TENSOR_MAP_SWIZZLE_128B,
                           head_dim, seq_q, heads, batch, 16, (int64_t)heads * seq_q * head_dim,
                           (int64_t)seq_q * head_dim, head_dim))
    return cudaErrorInvalidValue;
  BwdParams p = make_params(lse, delta, kv_lens, rope_cos, rope_sin, batch, heads, seq_q, seq_kv, rope_sn);
  p.dk = dk;
  p.dv = dv;
  p.dq_acc = dq_acc;
  p.dk_sb = strides[12]; p.dk_sn = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sn = strides[16]; p.dv_ss = strides[17];
  BwdParams k2 = p;  // the kernel writes dk and dv, or with splits > 1 the partials
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
  if (dtype == 0 && head_dim == 64) err = launch_dkdv<__nv_bfloat16, 64, FUSED>(maps, k2, s);
  else if (dtype == 0) err = launch_dkdv<__nv_bfloat16, 128, FUSED>(maps, k2, s);
  else if (head_dim == 64) err = launch_dkdv<__half, 64, FUSED>(maps, k2, s);
  else err = launch_dkdv<__half, 128, FUSED>(maps, k2, s);
  if (err != cudaSuccess || splits == 1) return err;
  p.splits = splits;
  if (dtype == 0 && head_dim == 64) return launch_reduce<__nv_bfloat16, 64>(dk_part, dv_part, p, s);
  if (dtype == 0) return launch_reduce<__nv_bfloat16, 128>(dk_part, dv_part, p, s);
  if (head_dim == 64) return launch_reduce<__half, 64>(dk_part, dv_part, p, s);
  return launch_reduce<__half, 128>(dk_part, dv_part, p, s);
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
  return dkdv_entry<false>(q_s, k_r, v, dout, lse, delta, kv_lens, rope_cos, rope_sin, dk, dv, partials, nullptr,
                           batch, heads, seq_q, seq_kv, head_dim, dtype, strides, rope_sn, splits, q_tiles_per_split,
                           stream);
}

// K5: K2's arguments, and dq_acc, the fp32 (B, N, Sq, H) contiguous buffer of
// zeros into which it adds sum_kv ds k_r (before the scale and the transpose
// rotation, which the dq emit in flash_bwd.cu applies).
extern "C" int flash_bwd_fused_sm90(const void* q_s, const void* k_r, const void* v, const void* dout,
                                    const void* lse, const void* delta, const void* kv_lens, const void* rope_cos,
                                    const void* rope_sin, void* dk, void* dv, void* partials, void* dq_acc, int batch,
                                    int heads, int seq_q, int seq_kv, int head_dim, int dtype, const int64_t* strides,
                                    int64_t rope_sn, int splits, int q_tiles_per_split, void* stream) {
  return dkdv_entry<true>(q_s, k_r, v, dout, lse, delta, kv_lens, rope_cos, rope_sin, dk, dv, partials,
                          static_cast<float*>(dq_acc), batch, heads, seq_q, seq_kv, head_dim, dtype, strides, rope_sn,
                          splits, q_tiles_per_split, stream);
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
