// Flash attention forward variants for Hopper (sm_90a), CUDA C++ with
// mma.sync: K7a (two-pass), K7b (skewed) and K7c (two-level). K1 itself is the
// wgmma kernel in flash_fwd_sm90.cu.
//
// Replaces: the `two_level` branch of finetrainers_tpu/ops/flash_attention.py::
// _fwd_kernel (K7c), ::_fwd_kernel_twopass (K7a) and ::_fwd_kernel_skew (K7b)
// (Pallas, TPU), picked there by _flash_forward from the
// FINETRAINERS_FLASH_SKEW / _TWOPASS / _TWOLEVEL switches. They compute K1's
// function: online-softmax attention in base 2 with scale*log2(e) folded into
// q, an optional per-batch kv_lens padding mask, the output in the input dtype
// and the natural-log LSE (m*ln2 + log l); rows with no valid key give 0
// output. K7a and K7c read the pre-pass's operands (`rope_prep_kernel` in
// flash_bwd.cu, run first by the wrapper): q_s = T(rope(q)*scale*log2e) and
// k_r = T(rope(k)), with a q scale of 1 here. K7b takes no RoPE tables (as the
// JAX package gates it) and scales q as its tile lands. They differ only in the
// order of the softmax arithmetic:
//   K7c  p = exp2(s - m_cur) against the tile's own max m_cur, so p and p v do
//        not wait for the running max; beta = exp2(m_cur - m_new);
//        l = l*alpha + rowsum(p)*beta; acc = acc*alpha + (p v)*beta
//   K7a  pass A sweeps every kv tile for the row max only; pass B recomputes
//        s and accumulates p = exp2(s - m) with no rescale (1.5x the QK^T
//        products)
//   K7b  iteration j issues tile j's QK^T, then runs K1's softmax step on tile
//        j-1's scores from the previous iteration (two score fragments live);
//        the first step processes a dummy tile of 2*(-1e30), a last one drains
// Every kernel exponentiates and sums in fp32 and rounds p to the input dtype
// only as the A operand of P V (as K1 does; the TPU's two-level kernel
// exponentiates in v's dtype at H < 128).
//
// What bounds them on this card: K1's work, 4*B*N*Sq*Skv*H operations (K7a
// 6*...) against the bytes of q, k, v and out: about 1,340 operations per byte
// at LTX's self-attention shape, far above the H100's ~295 FLOP/byte ridge, so
// they are compute-bound.
//
// What this design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16/fp16 in, fp32 accumulate); the S tile never leaves
// registers (its accumulator fragment is re-packed as the A operand of PV);
// running max, denominator and output accumulator stay in fp32 registers.
// One CTA of 8 warps owns a 128-row q tile of one (batch, head) and loops over
// 64-row kv tiles; each warp owns 16 q rows. The next k/v tile is fetched with
// cp.async into a second buffer while the current tile is computed. K7c folds
// each 32-column chunk of P V into acc as soon as it is computed, so no second
// full accumulator lives in registers. Not used: wgmma, TMA and warp
// specialisation (K1 has them).

#include "flash_common.cuh"

namespace {

// Warps per CTA; each warp owns 16 q rows, so a CTA owns 16 * kWarps.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;
constexpr int kBlockKV = 64;
constexpr int kSTiles = kBlockKV / 8;  // n-tiles of the S tile
constexpr int kPSteps = kBlockKV / 16;  // k-steps of P V
// CTAs per SM the register allocation must allow. At H=64 two CTAs fit an SM
// (54 KB of shared memory each) if a thread keeps to 128 registers; the
// mma.sync K1 these kernels shared their body with ran one CTA per SM and ~25%
// slower at LTX's shape at 129 registers (PERF.md).
template <int HD>
constexpr int min_ctas_per_sm() {
  return HD == 64 ? 2 : 1;
}

// The `variant` argument of the C entry point (0, K1, is flash_fwd_sm90.cu's).
enum Variant { kTwoLevel = 1, kTwoPass = 2, kSkew = 3 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;             // (B, N, Sq) contiguous
  const int* kv_lens;  // (B,) or nullptr
  int heads, seq_q, seq_kv;
  int64_t q_sb, q_sn, q_ss;
  int64_t k_sb, k_sn, k_ss;
  int64_t v_sb, v_sn, v_ss;
  int64_t o_sb, o_sn, o_ss;
  float qscale;  // softmax scale * log2(e) (K7b), or 1 on the pre-pass's q_s
};

// The q tile: rows row0.. of a (S, HD) slice with row stride `ss`, scaled by
// `mul` and rounded to T, into shared memory with row stride HD + 8. Rows at or
// past `rows_valid` are zero. Loaded once per CTA.
template <typename T, int HD>
__device__ __forceinline__ void load_q_tile(T* dst, const T* src, int64_t ss, int row0, int rows_valid, float mul) {
  constexpr int kVecPerRow = HD / 8;
  for (int idx = threadIdx.x; idx < kBlockQ * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows_valid)
      val = rope_scale_8<T>(*reinterpret_cast<const uint4*>(src + row * ss + c), nullptr, nullptr, mul);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

// Shared memory: [q tile | 2 k tiles | 2 v tiles], each row HD + 8 wide.
template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (kBlockQ + 4 * kBlockKV) * (HD + 8) * (int)sizeof(T);
}

// S = Q K^T for this warp's 16 rows x 64 kv columns (base-2 logits), with the
// columns at or past `kv_len` set to -1e30 when the tile starting at `k0` is ragged.
template <typename T, int HD>
__device__ __forceinline__ void scores(float (*s)[4], const uint32_t (*qf)[4], const T* k_tile, int k0, int kv_len) {
  constexpr int kLds = HD + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kSTiles; j += 2) {
      // matrices: (kv j*8.., h lo), (kv j*8.., h hi), (kv (j+1)*8.., h lo), (kv (j+1)*8.., h hi)
      const int mi = lane / 8;
      uint32_t bf[4];
      ldmatrix_x4(bf, k_tile + (j * 8 + (mi / 2) * 8 + lane % 8) * kLds + kk * 16 + (mi % 2) * 8);
      Ops<T>::mma(s[j], qf[kk], bf);
      Ops<T>::mma(s[j + 1], qf[kk], bf + 2);
    }
  }
  if (k0 + kBlockKV > kv_len) {  // ragged last tile: mask columns at or past kv_len
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * (lane % 4) + (e & 1);
        if (col >= kv_len) s[j][e] = kNegInf;
      }
    }
  }
}

// The max of each of this thread's two rows (lane/4 and lane/4 + 8) over the
// tile, reduced over the quad that shares the row.
__device__ __forceinline__ void tile_row_max(const float (*s)[4], float* tmax) {
  tmax[0] = tmax[1] = 2.f * kNegInf;
#pragma unroll
  for (int j = 0; j < kSTiles; ++j) {
    tmax[0] = fmaxf(tmax[0], fmaxf(s[j][0], s[j][1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
  }
}

// s <- exp2(s - sub[row]) in place; returns this thread's partial row sums.
__device__ __forceinline__ void exp2_rows(float (*s)[4], const float* sub, float* rowsum) {
  rowsum[0] = rowsum[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kSTiles; ++j) {
    s[j][0] = fast_exp2(s[j][0] - sub[0]);
    s[j][1] = fast_exp2(s[j][1] - sub[0]);
    s[j][2] = fast_exp2(s[j][2] - sub[1]);
    s[j][3] = fast_exp2(s[j][3] - sub[1]);
    rowsum[0] += s[j][0] + s[j][1];
    rowsum[1] += s[j][2] + s[j][3];
  }
}

template <int NT>
__device__ __forceinline__ void scale_rows(float (*acc)[4], const float* f) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    acc[i][0] *= f[0];
    acc[i][1] *= f[0];
    acc[i][2] *= f[1];
    acc[i][3] *= f[1];
  }
}

// The S accumulator fragments re-packed as the A fragments of P V (p rounded to T).
template <typename T>
__device__ __forceinline__ void pack_p(const float (*s)[4], uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk) {
    pa[kk][0] = Ops<T>::pack(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = Ops<T>::pack(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = Ops<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = Ops<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc[i - I0] += (P V)[:, i*8 .. i*8+8] for the NT output n-tiles from I0.
template <typename T, int HD, int NT>
__device__ __forceinline__ void pv_mma(float (*acc)[4], const uint32_t (*pa)[4], const T* v_tile, int i0) {
  constexpr int kLds = HD + 8;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
    for (int i = 0; i < NT; i += 2) {
      // matrices: (kv lo, h i*8..), (kv hi, h i*8..), (kv lo, h (i+1)*8..), (kv hi, h (i+1)*8..)
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, v_tile + (kk * 16 + (mi % 2) * 8 + lane % 8) * kLds + (i0 + i) * 8 + (mi / 2) * 8);
      Ops<T>::mma(acc[i], pa[kk], bf);
      Ops<T>::mma(acc[i + 1], pa[kk], bf + 2);
    }
  }
}

// out = acc / l in T and lse = m*ln2 + log(l) for this warp's 16 rows; l is
// this thread's partial row sum, reduced over the quad here.
template <typename T, int HD>
__device__ __forceinline__ void emit(const Params& p, const float (*acc)[4], const float* m, float* l, int b, int n,
                                     int q0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* o = static_cast<T*>(p.out) + b * p.o_sb + n * p.o_sn;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;  // no valid column: output 0, LSE = m*ln2
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.seq_q) continue;
    T* orow = o + row * p.o_ss + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) = Ops<T>::pack(acc[i][2 * r] * inv[r], acc[i][2 * r + 1] * inv[r]);
    if (lane % 4 == 0) p.lse[((int64_t)b * p.heads + n) * p.seq_q + row] = m[r] * kLn2 + logf(l[r]);
  }
}

// The per-CTA state every variant shares: operand pointers of this (batch,
// head) and the valid key count.
struct Tile {
  const void* q;
  const void* k;
  const void* v;
  int kv_len, num_tiles, q0, b, n;
};

template <typename T>
__device__ __forceinline__ Tile tile_of(const Params& p) {
  Tile t;
  t.q0 = blockIdx.x * kBlockQ;
  t.n = blockIdx.y;
  t.b = blockIdx.z;
  t.q = static_cast<const T*>(p.q) + t.b * p.q_sb + t.n * p.q_sn;
  t.k = static_cast<const T*>(p.k) + t.b * p.k_sb + t.n * p.k_sn;
  t.v = static_cast<const T*>(p.v) + t.b * p.v_sb + t.n * p.v_sn;
  t.kv_len = p.seq_kv;
  if (p.kv_lens != nullptr) t.kv_len = min(max(p.kv_lens[t.b], 0), p.seq_kv);
  t.num_tiles = (t.kv_len + kBlockKV - 1) / kBlockKV;
  return t;
}

// This warp's 16 q rows as mma A fragments, from the loaded q tile.
template <typename T, int HD>
__device__ __forceinline__ void q_fragments(uint32_t (*qf)[4], const T* s_q) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], s_q + (warp * 16 + (lane % 16)) * (HD + 8) + kk * 16 + (lane / 16) * 8);
}

// K7c: p against each tile's own max; the running max enters through alpha (on
// the old state) and beta (on this tile's contribution).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, min_ctas_per_sm<HD>()) flash_fwd_two_level_kernel(const Params p) {
  constexpr int kLds = HD + 8;
  constexpr int kOTiles = HD / 8;  // n-tiles of the output accumulator

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + kBlockQ * kLds;      // two k buffers
  T* s_v = s_k + 2 * kBlockKV * kLds;  // two v buffers

  const Tile tl = tile_of<T>(p);
  const T* k = static_cast<const T*>(tl.k);
  const T* v = static_cast<const T*>(tl.v);
  const int kv_len = tl.kv_len, num_tiles = tl.num_tiles;
  if (num_tiles > 0) {  // start fetching k/v tile 0 while q is loaded
    copy_tile_async<T, HD, kBlockKV, kThreads>(s_k, k, p.k_ss, kv_len);
    copy_tile_async<T, HD, kBlockKV, kThreads>(s_v, v, p.v_ss, kv_len);
  }
  cp_async_commit();
  load_q_tile<T, HD>(s_q, static_cast<const T*>(tl.q), p.q_ss, tl.q0, p.seq_q, p.qscale);
  __syncthreads();

  uint32_t qf[HD / 16][4];
  q_fragments<T, HD>(qf, s_q);

  float acc[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // Each thread holds two rows: lane/4 (fragment slots 0,1) and lane/4+8 (slots 2,3).
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced over the quad at the end

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockKV;
    T* k_tile = s_k + (t & 1) * kBlockKV * kLds;
    T* v_tile = s_v + (t & 1) * kBlockKV * kLds;
    cp_async_wait_all();  // this thread's pieces of tile t have landed
    // Tile t is visible to every warp; every warp is done with tile t-1's
    // buffers, which the prefetch below overwrites.
    __syncthreads();
    if (t + 1 < num_tiles) {  // prefetch tile t+1 while tile t is computed
      const int k1 = k0 + kBlockKV;
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_k + ((t + 1) & 1) * kBlockKV * kLds, k + k1 * p.k_ss, p.k_ss, kv_len - k1);
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_v + ((t + 1) & 1) * kBlockKV * kLds, v + k1 * p.v_ss, p.v_ss, kv_len - k1);
      cp_async_commit();
    }

    float s[kSTiles][4];
    scores<T, HD>(s, qf, k_tile, k0, kv_len);
    // Every processed tile has at least one valid column, so its max is finite
    // and masked entries underflow to exactly 0.
    float tmax[2], alpha[2], beta[2], rowsum[2];
    tile_row_max(s, tmax);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      beta[r] = fast_exp2(tmax[r] - m_new);
      m[r] = m_new;
    }
    exp2_rows(s, tmax, rowsum);
    l[0] = l[0] * alpha[0] + rowsum[0] * beta[0];
    l[1] = l[1] * alpha[1] + rowsum[1] * beta[1];
    uint32_t pa[kPSteps][4];
    pack_p<T>(s, pa);
    // P V in 32-column chunks, each folded into acc before the next: no
    // second full accumulator in registers.
#pragma unroll
    for (int c = 0; c < kOTiles; c += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0.f;
      pv_mma<T, HD, 4>(pv, pa, v_tile, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[c + i][0] = acc[c + i][0] * alpha[0] + pv[i][0] * beta[0];
        acc[c + i][1] = acc[c + i][1] * alpha[0] + pv[i][1] * beta[0];
        acc[c + i][2] = acc[c + i][2] * alpha[1] + pv[i][2] * beta[1];
        acc[c + i][3] = acc[c + i][3] * alpha[1] + pv[i][3] * beta[1];
      }
    }
  }
  emit<T, HD>(p, acc, m, l, tl.b, tl.n, tl.q0);
}

// K7a: iteration `it` of 2 * num_tiles runs pass A (row max only) on tile it,
// then pass B (accumulate against the final max) on tile it - num_tiles. k is
// fetched in both passes, v in pass B only.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, min_ctas_per_sm<HD>()) flash_fwd_twopass_kernel(const Params p) {
  constexpr int kLds = HD + 8;
  constexpr int kOTiles = HD / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + kBlockQ * kLds;
  T* s_v = s_k + 2 * kBlockKV * kLds;

  const Tile tl = tile_of<T>(p);
  const T* k = static_cast<const T*>(tl.k);
  const T* v = static_cast<const T*>(tl.v);
  const int kv_len = tl.kv_len, num_tiles = tl.num_tiles, total = 2 * num_tiles;
  if (num_tiles > 0) copy_tile_async<T, HD, kBlockKV, kThreads>(s_k, k, p.k_ss, kv_len);
  cp_async_commit();
  load_q_tile<T, HD>(s_q, static_cast<const T*>(tl.q), p.q_ss, tl.q0, p.seq_q, p.qscale);
  __syncthreads();

  uint32_t qf[HD / 16][4];
  q_fragments<T, HD>(qf, s_q);

  float acc[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < total; ++it) {
    const bool accumulate = it >= num_tiles;
    const int k0 = (accumulate ? it - num_tiles : it) * kBlockKV;
    T* k_tile = s_k + (it & 1) * kBlockKV * kLds;
    T* v_tile = s_v + (it & 1) * kBlockKV * kLds;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < total) {
      const int k1 = (it + 1 >= num_tiles ? it + 1 - num_tiles : it + 1) * kBlockKV;
      const int slot = ((it + 1) & 1) * kBlockKV * kLds;
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_k + slot, k + k1 * p.k_ss, p.k_ss, kv_len - k1);
      if (it + 1 >= num_tiles)
        copy_tile_async<T, HD, kBlockKV, kThreads>(s_v + slot, v + k1 * p.v_ss, p.v_ss, kv_len - k1);
      cp_async_commit();
    }

    float s[kSTiles][4];
    scores<T, HD>(s, qf, k_tile, k0, kv_len);
    if (!accumulate) {
      float tmax[2];
      tile_row_max(s, tmax);
      m[0] = fmaxf(m[0], tmax[0]);
      m[1] = fmaxf(m[1], tmax[1]);
      continue;
    }
    // m is final and finite (the row has a valid key), so masked entries give p = 0.
    float rowsum[2];
    exp2_rows(s, m, rowsum);
    l[0] += rowsum[0];
    l[1] += rowsum[1];
    uint32_t pa[kPSteps][4];
    pack_p<T>(s, pa);
    pv_mma<T, HD, kOTiles>(acc, pa, v_tile, 0);
  }
  emit<T, HD>(p, acc, m, l, tl.b, tl.n, tl.q0);
}

// K7b (no RoPE): iteration t issues tile t's QK^T, then runs K1's softmax
// step on the previous iteration's scores with v tile t-1. k tile t+1 and v
// tile t are fetched during iteration t; iteration num_tiles only drains.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_skew_kernel(const Params p) {
  constexpr int kLds = HD + 8;
  constexpr int kOTiles = HD / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + kBlockQ * kLds;
  T* s_v = s_k + 2 * kBlockKV * kLds;

  const Tile tl = tile_of<T>(p);
  const T* k = static_cast<const T*>(tl.k);
  const T* v = static_cast<const T*>(tl.v);
  const int kv_len = tl.kv_len, num_tiles = tl.num_tiles;
  if (num_tiles > 0) copy_tile_async<T, HD, kBlockKV, kThreads>(s_k, k, p.k_ss, kv_len);
  cp_async_commit();
  load_q_tile<T, HD>(s_q, static_cast<const T*>(tl.q), p.q_ss, tl.q0, p.seq_q, p.qscale);
  __syncthreads();

  uint32_t qf[HD / 16][4];
  q_fragments<T, HD>(qf, s_q);

  float acc[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // The previous tile's scores: a dummy far below the max's floor at first,
  // so exp2(s - m) is exactly 0 and alpha = 1.
  float s_prev[kSTiles][4];
#pragma unroll
  for (int j = 0; j < kSTiles; ++j) s_prev[j][0] = s_prev[j][1] = s_prev[j][2] = s_prev[j][3] = 2.f * kNegInf;

  for (int t = 0; t <= num_tiles; ++t) {
    cp_async_wait_all();  // k tile t and v tile t-1 have landed
    // Every warp is done with k tile t-1 and v tile t-2, whose buffers the
    // fetches below overwrite.
    __syncthreads();
    if (t + 1 < num_tiles) {
      const int k1 = (t + 1) * kBlockKV;
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_k + ((t + 1) & 1) * kBlockKV * kLds, k + k1 * p.k_ss, p.k_ss, kv_len - k1);
    }
    if (t < num_tiles) {
      const int k0 = t * kBlockKV;
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_v + (t & 1) * kBlockKV * kLds, v + k0 * p.v_ss, p.v_ss, kv_len - k0);
    }
    cp_async_commit();

    // Tile t's scores: independent of the softmax step below.
    float s_cur[kSTiles][4];
    if (t < num_tiles) scores<T, HD>(s_cur, qf, s_k + (t & 1) * kBlockKV * kLds, t * kBlockKV, kv_len);

    // K1's step on tile t-1 (the dummy at t = 0). A masked entry is recovered
    // from its stored score.
    float tmax[2], alpha[2], rowsum[2];
    tile_row_max(s_prev, tmax);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    rowsum[0] = rowsum[1] = 0.f;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = fast_exp2(s_prev[j][e] - m[e / 2]);
        s_prev[j][e] = s_prev[j][e] > 0.5f * kNegInf ? pv : 0.f;
        rowsum[e / 2] += s_prev[j][e];
      }
    }
    l[0] = l[0] * alpha[0] + rowsum[0];
    l[1] = l[1] * alpha[1] + rowsum[1];
    scale_rows<kOTiles>(acc, alpha);
    if (t > 0) {  // the dummy's p is exactly 0: it adds nothing to acc
      uint32_t pa[kPSteps][4];
      pack_p<T>(s_prev, pa);
      pv_mma<T, HD, kOTiles>(acc, pa, s_v + ((t - 1) & 1) * kBlockKV * kLds, 0);
    }
    if (t < num_tiles) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s_prev[j][e] = s_cur[j][e];
      }
    }
  }
  emit<T, HD>(p, acc, m, l, tl.b, tl.n, tl.q0);
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, int variant, cudaStream_t stream) {
  void (*kernel)(const Params) = nullptr;
  switch (variant) {
    case kTwoLevel: kernel = flash_fwd_two_level_kernel<T, HD>; break;
    case kTwoPass: kernel = flash_fwd_twopass_kernel<T, HD>; break;
    case kSkew: kernel = flash_fwd_skew_kernel<T, HD>; break;
  }
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_q + kBlockQ - 1) / kBlockQ, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = bf16, 1 = fp16.
// variant: 1 = K7c (two-level), 2 = K7a (two-pass), 3 = K7b (skewed); 0 (K1)
// is refused here. K7a and K7c take the pre-pass's q_s and k_r with qscale 1,
// K7b the raw q and k with qscale = scale * log2(e). Strides are in elements;
// the head dim is contiguous. Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const void* kv_lens,
                         int batch, int heads, int seq_q, int seq_kv, int head_dim, int dtype, int variant,
                         int64_t q_sb, int64_t q_sn, int64_t q_ss,
                         int64_t k_sb, int64_t k_sn, int64_t k_ss,
                         int64_t v_sb, int64_t v_sn, int64_t v_ss,
                         int64_t o_sb, int64_t o_sn, int64_t o_ss,
                         float qscale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_ss = o_ss;
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) err = launch<__nv_bfloat16, 64>(p, batch, variant, s);
  else if (dtype == 0 && head_dim == 128) err = launch<__nv_bfloat16, 128>(p, batch, variant, s);
  else if (dtype == 1 && head_dim == 64) err = launch<__half, 64>(p, batch, variant, s);
  else if (dtype == 1 && head_dim == 128) err = launch<__half, 128>(p, batch, variant, s);
  return static_cast<int>(err);
}
