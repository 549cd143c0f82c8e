// The fused flash attention backward K5 for Hopper (sm_90a), CUDA C++ with
// mma.sync, its dq emit, and the pre-pass that rotates and scales q and k once
// per call for every backward (K2/K3 in flash_bwd_sm90.cu, K5 here) and for the
// forwards K1, K7a and K7c.
//
// The pre-pass computes q_s = T(rope(q) * scale * log2(e)) and k_r = T(rope(k)),
// T() rounding to the input dtype, in place of the JAX kernels' per-tile
// rotation and q scaling.
//
// K5 replaces finetrainers_tpu/ops/flash_attention.py::_bwd_fused_kernel
// (Pallas, TPU; picked there by FINETRAINERS_FLASH_FUSED_BWD). It computes K2's
// and K3's functions (flash_bwd_sm90.cu) at the same rounding points, in base 2:
//   s   = q_s k_r^T                     (fp32 accumulate, base-2 logits)
//   p   = T(exp2(s - lse * log2(e)))    selected to 0 at kv >= kv_lens[b]
//   dv  = sum_q p^T dO                  (fp32) -> T
//   ds  = T(p * T(dO v^T - delta))      delta = rowsum(dO * out), given
//   dk  = rope^T(ln2 * sum_q ds^T q_s)  -> T
//   dq  = rope^T(scale * sum_kv ds k_r) -> T
// where rope^T is the transpose rotation g*cos - rotate(g)*sin (`_rope_bwd`),
// applied with the tables of k (dk) or of q (dq). Rows with no valid key
// (kv_lens[b] == 0) get dq = 0; keys at or past kv_lens[b] get dk = dv = 0. The
// mask is a select, never a multiply: for an empty row the LSE is -1e30*ln2
// and exp2 overflows to +inf, which a select discards and a 0/1 product would
// turn into NaN. Kv tiles at or past kv_lens[b] are skipped altogether.
//
// What bounds it on this card: at Wan's training shape (B=1, N=12, S=19,968,
// H=128) its five products are 10*N*S*S*H = 6.1 TFLOP against ~0.5 GB moved,
// far above the H100's ~295 FLOP/byte ridge: bound by operations.
//
// What this design does about it: one CTA of 4 warps owns a 64-row kv tile of
// one (batch, head), each warp owning 16 kv rows, and loops over q tiles
// (64 rows at H=64, 32 at H=128), double-buffered with cp.async. Every
// product is computed in the transposed form (kv rows as the M dimension) on
// mma.sync m16n8k16, so s, p, dp and ds never leave registers and the dk/dv
// accumulators stay in fp32 registers for the whole loop. It also adds each q
// tile's ds k_r into an fp32 (B, N, Sq, H) dq accumulator in device memory, so
// s, p, dp and ds are computed once per (kv tile, q tile) pair instead of
// twice. The TPU kernel keeps that accumulator in VMEM; here CTAs of other kv
// tiles add into the same rows, so each addition is an atomic add (fp32, in an
// order that varies from run to run). A warp holds ds^T for its 16 kv rows,
// but kv is the contraction dim of ds k_r: ds^T is staged in shared memory and
// each warp computes a 16-row x 64-column piece of the dq tile from there in
// 32-column chunks, adding each chunk before the next, so no second full
// accumulator lives in registers. A small emit kernel then applies the scale,
// the transpose rotation with q's tables and the cast. Not yet used: wgmma,
// TMA and warp specialisation (K2/K3 have them).

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // kv rows a CTA owns

// Rows of the streamed q tile.
template <int HD>
__host__ __device__ constexpr int block_n() { return HD == 64 ? 64 : 32; }

struct PrepParams {
  const void* q;
  const void* k;
  void* q_out;            // (B, N, Sq, H) contiguous
  void* k_out;            // (B, N, Skv, H) contiguous, or nullptr for no rotation of k
  const float* rope_cos;  // (N or 1, S, H) contiguous, or nullptr
  const float* rope_sin;
  int batch, heads, seq_q, seq_kv;
  int64_t q_sb, q_sn, q_ss;
  int64_t k_sb, k_sn, k_ss;
  int64_t rope_sn;
  float qscale;
};

struct BwdParams {
  const void* q;          // q_s from the pre-pass
  const void* k;          // k_r from the pre-pass, or k itself without RoPE
  const void* v;
  const void* dout;
  const float* lse;       // (B, N, Sq) natural log
  const float* delta;     // (B, N, Sq)
  const int* kv_lens;     // (B,) or nullptr
  const float* rope_cos;  // (N or 1, S, H) contiguous, or nullptr
  const float* rope_sin;
  void* dq;
  void* dk;
  void* dv;
  float* dq_acc;  // K5: (B, N, Sq, H) contiguous fp32, zeroed by the caller
  int heads, seq_q, seq_kv;
  int64_t q_sb, q_sn, q_ss;
  int64_t k_sb, k_sn, k_ss;
  int64_t v_sb, v_sn, v_ss;
  int64_t do_sb, do_sn, do_ss;
  int64_t dq_sb, dq_sn, dq_ss;
  int64_t dk_sb, dk_sn, dk_ss;
  int64_t dv_sb, dv_sn, dv_ss;
  int64_t rope_sn;
  float scale;  // softmax scale, applied to dq at emit
};

// q_s and, with tables, k_r: 16 bytes per thread, grid-stride; blockIdx.y = 0
// for q, 1 for k.
template <typename T, int HD>
__global__ void __launch_bounds__(256) rope_prep_kernel(const PrepParams p) {
  constexpr int kVecPerRow = HD / 8;
  const bool is_k = blockIdx.y == 1;
  const T* src = static_cast<const T*>(is_k ? p.k : p.q);
  T* dst = static_cast<T*>(is_k ? p.k_out : p.q_out);
  const int seq = is_k ? p.seq_kv : p.seq_q;
  const int64_t sb = is_k ? p.k_sb : p.q_sb, sn = is_k ? p.k_sn : p.q_sn, ss = is_k ? p.k_ss : p.q_ss;
  const float mul = is_k ? 1.f : p.qscale;
  const int64_t total = (int64_t)p.batch * p.heads * seq * kVecPerRow;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % kVecPerRow) * 8;
    const int64_t row = idx / kVecPerRow;  // (b, n, s) flattened
    const int s = (int)(row % seq);
    const int n = (int)((row / seq) % p.heads);
    const int b = (int)(row / ((int64_t)seq * p.heads));
    const uint4 val = *reinterpret_cast<const uint4*>(src + b * sb + n * sn + s * ss + c);
    const float* cos = nullptr;
    const float* sin = nullptr;
    if (p.rope_cos != nullptr) {
      const int64_t t = n * p.rope_sn + (int64_t)s * HD + c;
      cos = p.rope_cos + t;
      sin = p.rope_sin + t;
    }
    *reinterpret_cast<uint4*>(dst + row * HD + c) = rope_scale_8<T>(val, cos, sin, mul);
  }
}

// Write a warp's 16 x HD fp32 accumulator (mma C layout) times `mul`, rotated
// back when `cos` is set, as T to rows row0.. (row stride `ss`), skipping rows
// at or past `rows`. `cos`/`sin` point at table row 0 of this head.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, int64_t ss, const float (*acc)[4], int row0, int rows, float mul,
                                           const float* cos, const float* sin) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + r * 8;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int col = i * 8 + 2 * (lane % 4);
      float2 g = make_float2(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
      if (cos != nullptr) {
        const int64_t t = (int64_t)row * HD + col;
        g = rope_bwd_pair(g.x, g.y, cos + t, sin + t);
      }
      *reinterpret_cast<uint32_t*>(dst + row * ss + col) = Ops<T>::pack(g.x, g.y);
    }
  }
}

// acc[16 x 8*NT] += A[16 x 16*KS] B^T with the warp's A rows at `a` and B rows
// at `b` (both [row][k] in shared memory, row stride HD + 8): the QK^T-shaped
// product.
template <typename T, int HD, int KS, int NT>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const T* a, const T* b) {
  constexpr int kLds = HD + 8;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane % 16) * kLds + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // matrices: (n j*8.., k lo), (n j*8.., k hi), (n (j+1)*8.., k lo), (n (j+1)*8.., k hi)
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (j * 8 + (mi / 2) * 8 + lane % 8) * kLds + kk * 16 + (mi % 2) * 8);
      Ops<T>::mma(acc[j], af, bf);
      Ops<T>::mma(acc[j + 1], af, bf + 2);
    }
  }
}

// acc[16 x HD] += P[16 x 16*KS] B with P in registers (the accumulator layout
// of a 16 x 8*(2*KS) product, values already rounded to T) and B rows at `b`
// ([k][n] in shared memory, row stride HD + 8): the PV-shaped product.
template <typename T, int HD, int KS>
__device__ __forceinline__ void mma_pb(float (*acc)[4], const float (*p)[4], const T* b) {
  constexpr int kLds = HD + 8;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t pa[4];
    pa[0] = Ops<T>::pack(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = Ops<T>::pack(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = Ops<T>::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = Ops<T>::pack(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int i = 0; i < HD / 8; i += 2) {
      // matrices: (k lo, n i*8..), (k hi, n i*8..), (k lo, n (i+1)*8..), (k hi, n (i+1)*8..)
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 + (mi % 2) * 8 + lane % 8) * kLds + i * 8 + (mi / 2) * 8);
      Ops<T>::mma(acc[i], pa, bf);
      Ops<T>::mma(acc[i + 1], pa, bf + 2);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// K5's share of one q tile of dq: dq_acc[q0 + r, :] += sum_kv ds[r, kv] k_r[kv, :]
// for the CTA's kBlockM kv rows, with ds^T staged in shared memory ([kv][q],
// row stride kN + 8) and k_r in the CTA's k tile. The kN x HD tile is split
// into 16-row x 64-column pieces, one per warp, computed and added to device
// memory (red.global.add.f32) 32 columns at a time; rows at or past seq_q are skipped.
template <typename T, int HD, int kN>
__device__ __forceinline__ void add_dq_tile(float* dq_acc, const T* s_ds, const T* s_k, int q0, int seq_q) {
  constexpr int kLdsK = HD + 8;
  constexpr int kLdsD = kN + 8;
  constexpr int kRowGroups = kN / 16;
  constexpr int kCols = HD * kRowGroups / kWarps;  // 64 at both head dims
  constexpr int kChunk = 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
  const int r0 = (warp % kRowGroups) * 16;
  const int c0 = (warp / kRowGroups) * kCols;
  // A fragments of ds (q rows r0.., kv columns): transposed loads of ds^T.
  // matrices: (q lo, kv lo), (q hi, kv lo), (q lo, kv hi), (q hi, kv hi)
  uint32_t af[kBlockM / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk)
    ldmatrix_x4_trans(af[kk], s_ds + (kk * 16 + (mi / 2) * 8 + lane % 8) * kLdsD + r0 + (mi % 2) * 8);
#pragma unroll
  for (int c = 0; c < kCols; c += kChunk) {
    float acc[kChunk / 8][4];
    zero<kChunk / 8>(acc);
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < kChunk / 8; i += 2) {
        // matrices: (kv lo, h i*8..), (kv hi, h i*8..), (kv lo, h (i+1)*8..), (kv hi, h (i+1)*8..)
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, s_k + (kk * 16 + (mi % 2) * 8 + lane % 8) * kLdsK + c0 + c + i * 8 + (mi / 2) * 8);
        Ops<T>::mma(acc[i], af[kk], bf);
        Ops<T>::mma(acc[i + 1], af[kk], bf + 2);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + lane / 4 + r * 8;
      if (row >= seq_q) continue;
      float* dst = dq_acc + (int64_t)row * HD + c0 + c + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < kChunk / 8; ++i) {
        atomicAdd(dst + i * 8, acc[i][2 * r]);
        atomicAdd(dst + i * 8 + 1, acc[i][2 * r + 1]);
      }
    }
  }
}

// K5: one CTA per (kv tile of kBlockM rows, head, batch); loops over q tiles.
// Each warp owns 16 kv rows and computes s^T, dp^T and ds^T for them, so p^T
// and ds^T are A operands of dv += p^T dO and dk += ds^T q_s as they stand;
// each q tile's ds k_r is also added into dq_acc.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_fused_kernel(const BwdParams p) {
  constexpr int kN = block_n<HD>();
  constexpr int kLds = HD + 8;
  constexpr int kSTiles = kN / 8;
  constexpr int kOTiles = HD / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + kBlockM * kLds;
  T* s_q = s_v + kBlockM * kLds;   // two q tiles
  T* s_do = s_q + 2 * kN * kLds;   // two dO tiles
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * kN * kLds);  // two tiles' LSE
  float* s_delta = s_lse + 2 * kN;                                // two tiles' delta
  T* s_ds = reinterpret_cast<T*>(s_delta + 2 * kN);                // K5: ds^T, kBlockM x (kN + 8)

  const int kv0 = blockIdx.x * kBlockM;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int kv_len = p.seq_kv;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.seq_kv);
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + n * p.dk_sn;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + n * p.dv_sn;

  float acc_dk[kOTiles][4], acc_dv[kOTiles][4];
  zero<kOTiles>(acc_dk);
  zero<kOTiles>(acc_dv);
  const float* cos = p.rope_cos != nullptr ? p.rope_cos + n * p.rope_sn : nullptr;
  const float* sin = p.rope_sin != nullptr ? p.rope_sin + n * p.rope_sn : nullptr;
  const int row0 = kv0 + warp * 16;
  if (kv0 >= kv_len) {  // every key of this tile is masked: dk = dv = 0
    store_rows<T, HD>(dk, p.dk_ss, acc_dk, row0, p.seq_kv, 1.f, nullptr, nullptr);
    store_rows<T, HD>(dv, p.dv_ss, acc_dv, row0, p.seq_kv, 1.f, nullptr, nullptr);
    return;
  }

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + n * p.do_sn;
  const float* lse = p.lse + ((int64_t)b * p.heads + n) * p.seq_q;
  const float* delta = p.delta + ((int64_t)b * p.heads + n) * p.seq_q;

  auto fetch_q_tile = [&](int t) {
    const int q0 = t * kN;
    const int buf = t & 1;
    copy_tile_async<T, HD, kN, kThreads>(s_q + buf * kN * kLds, q + q0 * p.q_ss, p.q_ss, p.seq_q - q0);
    copy_tile_async<T, HD, kN, kThreads>(s_do + buf * kN * kLds, dout + q0 * p.do_ss, p.do_ss, p.seq_q - q0);
    const int i = threadIdx.x;
    if (i < kN) {
      const bool valid = q0 + i < p.seq_q;
      cp_async_4(s_lse + buf * kN + i, valid ? lse + q0 + i : lse, valid);
    } else if (i < 2 * kN) {
      const bool valid = q0 + i - kN < p.seq_q;
      cp_async_4(s_delta + buf * kN + i - kN, valid ? delta + q0 + i - kN : delta, valid);
    }
  };

  // Keys past seq_kv are zero-filled; keys in [kv_len, seq_kv) are real data
  // whose p is selected to 0 below.
  copy_tile_async<T, HD, kBlockM, kThreads>(s_k, k + kv0 * p.k_ss, p.k_ss, p.seq_kv - kv0);
  copy_tile_async<T, HD, kBlockM, kThreads>(s_v, v + kv0 * p.v_ss, p.v_ss, p.seq_kv - kv0);
  fetch_q_tile(0);
  cp_async_commit();

  // This thread's two kv rows (fragment slots 0,1 and 2,3).
  const bool row_ok[2] = {row0 + lane / 4 < kv_len, row0 + lane / 4 + 8 < kv_len};
  const int num_tiles = (p.seq_q + kN - 1) / kN;
  for (int t = 0; t < num_tiles; ++t) {
    const int q0 = t * kN;
    const T* q_tile = s_q + (t & 1) * kN * kLds;
    const T* do_tile = s_do + (t & 1) * kN * kLds;
    const float* lse_t = s_lse + (t & 1) * kN;
    const float* delta_t = s_delta + (t & 1) * kN;
    cp_async_wait_all();  // this thread's pieces of tile t have landed
    // Tile t is visible to every warp; every warp is done with tile t-1's
    // buffers, which the prefetch below overwrites.
    __syncthreads();
    if (t + 1 < num_tiles) {
      fetch_q_tile(t + 1);
      cp_async_commit();
    }

    // s^T = k_r q_s^T for this warp's 16 kv rows x kN q columns (base-2 logits).
    float s[kSTiles][4];
    zero<kSTiles>(s);
    mma_abt<T, HD, HD / 16, kSTiles>(s, s_k + warp * 16 * kLds, q_tile);
    // p = T(exp2(s - lse*log2e)), selected to 0 for masked keys and padded q rows.
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * (lane % 4) + (e & 1);
        const float pv = Ops<T>::round(fast_exp2(s[j][e] - lse_t[col] * kLog2e));
        s[j][e] = (row_ok[e / 2] && q0 + col < p.seq_q) ? pv : 0.f;
      }
    }
    // dv += p^T dO
    mma_pb<T, HD, kN / 16>(acc_dv, s, do_tile);
    // dp^T = v dO^T
    float dp[kSTiles][4];
    zero<kSTiles>(dp);
    mma_abt<T, HD, HD / 16, kSTiles>(dp, s_v + warp * 16 * kLds, do_tile);
    // ds = T(p * T(dp - delta)), in dp's registers
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * (lane % 4) + (e & 1);
        dp[j][e] = Ops<T>::round(s[j][e] * Ops<T>::round(dp[j][e] - delta_t[col]));
      }
    }
    // dk += ds^T q_s
    mma_pb<T, HD, kN / 16>(acc_dk, dp, q_tile);
    // Stage ds^T (already rounded to T) for the dq product; the top of the
    // next iteration syncs before anyone writes it again.
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(s_ds + (warp * 16 + lane / 4 + r * 8) * (kN + 8) + j * 8 + 2 * (lane % 4)) =
            Ops<T>::pack(dp[j][2 * r], dp[j][2 * r + 1]);
    }
    __syncthreads();
    add_dq_tile<T, HD, kN>(p.dq_acc + ((int64_t)b * p.heads + n) * p.seq_q * HD, s_ds, s_k, q0, p.seq_q);
  }

  // dk carries a surplus log2(e) (the scale*log2e folded into q_s, less the
  // scale ds lacks): ln2 undoes it. Then the transpose rotation, with k's rows.
  store_rows<T, HD>(dk, p.dk_ss, acc_dk, row0, p.seq_kv, kLn2, cos, sin);
  store_rows<T, HD>(dv, p.dv_ss, acc_dv, row0, p.seq_kv, 1.f, nullptr, nullptr);
}

template <typename T, int HD>
cudaError_t launch_prep(const PrepParams& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.batch * p.heads * (p.seq_q > p.seq_kv ? p.seq_q : p.seq_kv);
  const int64_t blocks = (rows * (HD / 8) + 255) / 256;
  const dim3 grid((unsigned)(blocks < 4096 ? blocks : 4096), p.k_out != nullptr ? 2 : 1);
  rope_prep_kernel<T, HD><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// K5's emit: dq = T(rope^T(scale * dq_acc)) with q's tables, one column pair
// per thread, grid-stride.
template <typename T, int HD>
__global__ void __launch_bounds__(256) dq_emit_kernel(const BwdParams p, int batch) {
  const int64_t total = (int64_t)batch * p.heads * p.seq_q * (HD / 2);
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int col = (int)(idx % (HD / 2)) * 2;
    const int64_t row = idx / (HD / 2);  // (b, n, s) flattened
    const int s = (int)(row % p.seq_q);
    const int n = (int)((row / p.seq_q) % p.heads);
    const int b = (int)(row / ((int64_t)p.seq_q * p.heads));
    const float2 acc = *reinterpret_cast<const float2*>(p.dq_acc + row * HD + col);
    float2 g = make_float2(acc.x * p.scale, acc.y * p.scale);
    if (p.rope_cos != nullptr) {
      const int64_t t = n * p.rope_sn + (int64_t)s * HD + col;
      g = rope_bwd_pair(g.x, g.y, p.rope_cos + t, p.rope_sin + t);
    }
    *reinterpret_cast<uint32_t*>(static_cast<T*>(p.dq) + b * p.dq_sb + n * p.dq_sn + s * p.dq_ss + col) =
        Ops<T>::pack(g.x, g.y);
  }
}

template <typename T, int HD>
cudaError_t launch_fused(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kN = block_n<HD>();
  const size_t smem = (2 * kBlockM + 4 * kN) * (HD + 8) * sizeof(T) + 4 * kN * sizeof(float) +
                      kBlockM * (kN + 8) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(bwd_fused_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_kv + kBlockM - 1) / kBlockM, p.heads, batch);
  bwd_fused_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq_emit(const BwdParams& p, int batch, cudaStream_t stream) {
  const int64_t blocks = ((int64_t)batch * p.heads * p.seq_q * (HD / 2) + 255) / 256;
  dq_emit_kernel<T, HD><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(p, batch);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* kv_lens, const void* rope_cos, const void* rope_sin,
                      int heads, int seq_q, int seq_kv, const int64_t* strides, int64_t rope_sn) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sn = strides[7]; p.v_ss = strides[8];
  p.do_sb = strides[9]; p.do_sn = strides[10]; p.do_ss = strides[11];
  p.rope_sn = rope_sn;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = bf16, 1 = fp16. Strides
// are in elements; the head dim is contiguous. Each returns a cudaError_t.

// The pre-pass: q_out = T(rope(q) * qscale), and k_out = T(rope(k)) when k_out
// is given (then the tables must be too); both written (B, N, S, H) contiguous.
extern "C" int flash_qk_prep(const void* q, const void* k, void* q_out, void* k_out, const void* rope_cos,
                             const void* rope_sin, int batch, int heads, int seq_q, int seq_kv, int head_dim,
                             int dtype, int64_t q_sb, int64_t q_sn, int64_t q_ss, int64_t k_sb, int64_t k_sn,
                             int64_t k_ss, int64_t rope_sn, float qscale, void* stream) {
  PrepParams p = {};
  p.q = q;
  p.k = k;
  p.q_out = q_out;
  p.k_out = k_out;
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.batch = batch;
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_ss = k_ss;
  p.rope_sn = rope_sn;
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_prep<__nv_bfloat16, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch_prep<__nv_bfloat16, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch_prep<__half, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch_prep<__half, 128>(p, s);
  return cudaErrorInvalidValue;
}

// K5. strides: q, k, v, dO, dk, dv, each (batch, head, seq). dq_acc is an fp32
// (B, N, Sq, H) contiguous buffer of zeros, which K5 adds into.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                               const void* delta, const void* kv_lens, const void* rope_cos, const void* rope_sin,
                               void* dk, void* dv, void* dq_acc, int batch, int heads, int seq_q, int seq_kv,
                               int head_dim, int dtype, const int64_t* strides, int64_t rope_sn, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, kv_lens, rope_cos, rope_sin, heads, seq_q, seq_kv, strides,
                            rope_sn);
  p.dk = dk;
  p.dv = dv;
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dk_sb = strides[12]; p.dk_sn = strides[13]; p.dk_ss = strides[14];
  p.dv_sb = strides[15]; p.dv_sn = strides[16]; p.dv_ss = strides[17];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_fused<__nv_bfloat16, 64>(p, batch, s);
  if (dtype == 0 && head_dim == 128) return launch_fused<__nv_bfloat16, 128>(p, batch, s);
  if (dtype == 1 && head_dim == 64) return launch_fused<__half, 64>(p, batch, s);
  if (dtype == 1 && head_dim == 128) return launch_fused<__half, 128>(p, batch, s);
  return cudaErrorInvalidValue;
}

// K5's emit: dq (strides of dq: batch, head, seq) = T(rope^T(scale * dq_acc))
// with the (N or 1, Sq, H) tables when given.
extern "C" int flash_bwd_dq_emit(const void* dq_acc, const void* rope_cos, const void* rope_sin, void* dq, int batch,
                                 int heads, int seq_q, int head_dim, int dtype, int64_t dq_sb, int64_t dq_sn,
                                 int64_t dq_ss, int64_t rope_sn, float scale, void* stream) {
  BwdParams p = {};
  p.dq_acc = static_cast<float*>(const_cast<void*>(dq_acc));
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.dq = dq;
  p.heads = heads;
  p.seq_q = seq_q;
  p.dq_sb = dq_sb; p.dq_sn = dq_sn; p.dq_ss = dq_ss;
  p.rope_sn = rope_sn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_dq_emit<__nv_bfloat16, 64>(p, batch, s);
  if (dtype == 0 && head_dim == 128) return launch_dq_emit<__nv_bfloat16, 128>(p, batch, s);
  if (dtype == 1 && head_dim == 64) return launch_dq_emit<__half, 64>(p, batch, s);
  if (dtype == 1 && head_dim == 128) return launch_dq_emit<__half, 128>(p, batch, s);
  return cudaErrorInvalidValue;
}
