// Flash attention forward (K1) for Hopper (sm_90a), CUDA C++ with mma.sync.
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_fwd_kernel (Pallas, TPU),
// driven there by _flash_forward. It computes the same function: online-softmax
// attention in base 2 (scale*log2(e) folded into the q tile), optional fused
// interleaved-pair RoPE on q and k, an optional per-batch kv_lens padding mask,
// and it emits the output in the input dtype and the natural-log LSE
// (m*ln2 + log l). Rows with no valid key give 0 output.
//
// What bounds it on this card: at the LTX self-attention shape (B=2, N=32,
// S=2688, H=64) QK^T plus PV is 4*B*N*S*S*H = 118 GFLOP per call, against
// ~88 MB of q/k/v/out and ~44 MB of fp32 RoPE tables: about 900 operations
// per byte, far above the H100's ~295 FLOP/byte ridge. So it is
// compute-bound, and the tensor cores are the resource to feed.
//
// What this design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16/fp16 in, fp32 accumulate); the S tile never leaves
// registers (its accumulator fragment is re-packed as the A operand of PV);
// running max, denominator and output accumulator stay in fp32 registers.
// One CTA of 8 warps owns a 128-row q tile of one (batch, head) and loops over
// 64-row kv tiles; each warp owns 16 q rows. The next k/v tile, and with RoPE
// its fp32 table rows, are fetched with cp.async into a second buffer while
// the current tile is computed. q is rotated and scaled once, as it is loaded;
// each k tile is rotated in shared memory after it lands, so every CTA of a
// (batch, head) rotates all of k again: that work is ~6 ALU operations per k
// element per CTA, which is why the CTA is 128 q rows tall (it halves the
// re-rotation of a 64-row tile; measured on the H100 in PERF.md). Not yet
// used: wgmma, TMA and warp specialisation.

#include "flash_common.cuh"

namespace {

// Warps per CTA; each warp owns 16 q rows, so a CTA owns 16 * kWarps.
constexpr int kWarps = 8;
constexpr int kBlockKV = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;             // (B, N, Sq) contiguous
  const int* kv_lens;     // (B,) or nullptr
  const float* rope_cos;  // (N or 1, S, H) contiguous, or nullptr
  const float* rope_sin;
  int heads, seq_q, seq_kv;
  int64_t q_sb, q_sn, q_ss;
  int64_t k_sb, k_sn, k_ss;
  int64_t v_sb, v_sn, v_ss;
  int64_t o_sb, o_sn, o_ss;
  int64_t rope_sn;  // 0 when one table is shared by every head
  float qscale;     // softmax scale * log2(e)
};

// The q tile: rows row0.. of a (S, HD) slice with row stride `ss`, rotated
// (when `cos` is set) and scaled by `mul`, into shared memory with row stride
// HD + 8. Rows at or past `rows_valid` are zero. Loaded once per CTA.
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_q_tile(T* dst, const T* src, int64_t ss, int row0, int rows_valid,
                                            const float* cos, const float* sin, float mul) {
  constexpr int kVecPerRow = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * kVecPerRow; idx += THREADS) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows_valid) {
      const int64_t t = (int64_t)row * HD + c;
      val = rope_scale_8<T>(*reinterpret_cast<const uint4*>(src + row * ss + c),
                            cos != nullptr ? cos + t : nullptr, sin != nullptr ? sin + t : nullptr, mul);
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

// Start the asynchronous copy of the fp32 RoPE rows of a kv tile (rows of a
// (S, HD) table) into shared memory, unpadded. Thread `idx` copies the 32 bytes
// of cos and of sin that rotate_kv_tile later reads for its own piece.
template <int HD, int THREADS>
__device__ __forceinline__ void copy_rope_rows_async(float* dst_cos, float* dst_sin, const float* cos,
                                                     const float* sin, int rows_valid) {
  constexpr int kVecPerRow = HD / 8;
  for (int idx = threadIdx.x; idx < kBlockKV * kVecPerRow; idx += THREADS) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    const bool valid = r < rows_valid;
    const int o = r * HD + c;
    cp_async_16(dst_cos + o, valid ? cos + o : cos, valid);
    cp_async_16(dst_cos + o + 4, valid ? cos + o + 4 : cos, valid);
    cp_async_16(dst_sin + o, valid ? sin + o : sin, valid);
    cp_async_16(dst_sin + o + 4, valid ? sin + o + 4 : sin, valid);
  }
}

// Rotate a landed k tile in place with the landed table rows. Each thread
// touches exactly the pieces it copied, so its own cp.async wait suffices.
template <typename T, int HD, int THREADS>
__device__ __forceinline__ void rotate_kv_tile(T* tile, const float* cos, const float* sin, int rows_valid) {
  constexpr int kVecPerRow = HD / 8;
  for (int idx = threadIdx.x; idx < kBlockKV * kVecPerRow; idx += THREADS) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    if (r < rows_valid) {
      uint4* piece = reinterpret_cast<uint4*>(tile + r * (HD + 8) + c);
      *piece = rope_scale_8<T>(*piece, cos + r * HD + c, sin + r * HD + c, 1.f);
    }
  }
}

// Shared memory: [q tile, later reused for the k tile's fp32 RoPE rows | 2 k
// tiles | 2 v tiles]. The first region is as large as the larger of its uses.
template <typename T, int HD>
__host__ __device__ constexpr int smem_region0_bytes(bool rope) {
  return rope && 2 * kBlockKV * HD * 4 > 16 * kWarps * (HD + 8) * (int)sizeof(T)
             ? 2 * kBlockKV * HD * 4
             : 16 * kWarps * (HD + 8) * (int)sizeof(T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(const Params p) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kBlockQ = 16 * kWarps;
  constexpr int kLds = HD + 8;
  constexpr int kKSteps = HD / 16;       // k-steps of QK^T over the head dim
  constexpr int kSTiles = kBlockKV / 8;  // n-tiles of the S tile
  constexpr int kOTiles = HD / 8;        // n-tiles of the output accumulator

  extern __shared__ __align__(16) unsigned char smem[];
  const bool rope = p.rope_cos != nullptr;
  T* s_q = reinterpret_cast<T*>(smem);
  float* s_cos = reinterpret_cast<float*>(smem);  // reuses the q tile's space once q is in registers
  float* s_sin = s_cos + kBlockKV * HD;
  T* s_k = reinterpret_cast<T*>(smem + smem_region0_bytes<T, HD>(rope));  // two k buffers
  T* s_v = s_k + 2 * kBlockKV * kLds;                                      // two v buffers

  const int q0 = blockIdx.x * kBlockQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn;
  T* o = static_cast<T*>(p.out) + b * p.o_sb + n * p.o_sn;

  int kv_len = p.seq_kv;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.seq_kv);
  const float* cos = p.rope_cos != nullptr ? p.rope_cos + n * p.rope_sn : nullptr;
  const float* sin = p.rope_sin != nullptr ? p.rope_sin + n * p.rope_sn : nullptr;

  const int num_tiles = (kv_len + kBlockKV - 1) / kBlockKV;
  if (num_tiles > 0) {  // start fetching k/v tile 0 while q is rotated and scaled
    copy_tile_async<T, HD, kBlockKV, kThreads>(s_k, k, p.k_ss, kv_len);
    copy_tile_async<T, HD, kBlockKV, kThreads>(s_v, v, p.v_ss, kv_len);
  }
  cp_async_commit();
  load_q_tile<T, HD, kBlockQ, kThreads>(s_q, q, p.q_ss, q0, p.seq_q, cos, sin, p.qscale);
  __syncthreads();

  // This warp's 16 q rows as mma A fragments, kept in registers for the kv loop.
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldmatrix_x4(qf[kk], s_q + (warp * 16 + (lane % 16)) * kLds + kk * 16 + (lane / 16) * 8);
  if (rope && num_tiles > 0) {
    __syncthreads();  // every warp holds its q fragments: the q tile's space takes the table rows
    copy_rope_rows_async<HD, kThreads>(s_cos, s_sin, cos, sin, kv_len);
    cp_async_commit();
  }

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
    cp_async_wait_all();  // this thread's pieces of tile t (and its table rows) have landed
    if (rope) rotate_kv_tile<T, HD, kThreads>(k_tile, s_cos, s_sin, kv_len - k0);
    // Tile t is visible to every warp; every warp is done with tile t-1's
    // buffers and with the table rows, which the prefetch below overwrites.
    __syncthreads();
    if (t + 1 < num_tiles) {  // prefetch tile t+1 while tile t is computed
      const int k1 = k0 + kBlockKV;
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_k + ((t + 1) & 1) * kBlockKV * kLds, k + k1 * p.k_ss, p.k_ss, kv_len - k1);
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_v + ((t + 1) & 1) * kBlockKV * kLds, v + k1 * p.v_ss, p.v_ss, kv_len - k1);
      if (rope) copy_rope_rows_async<HD, kThreads>(s_cos, s_sin, cos + (int64_t)k1 * HD, sin + (int64_t)k1 * HD, kv_len - k1);
      cp_async_commit();
    }

    // S = Q K^T for this warp's 16 rows x 64 kv columns (base-2 logits).
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
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

    // Online softmax. Every processed tile has at least one valid column, so the
    // new max is finite and masked entries underflow to exactly 0.
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[j][0], s[j][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = fast_exp2(s[j][0] - m[0]);
      s[j][1] = fast_exp2(s[j][1] - m[0]);
      s[j][2] = fast_exp2(s[j][2] - m[1]);
      s[j][3] = fast_exp2(s[j][3] - m[1]);
      rowsum[0] += s[j][0] + s[j][1];
      rowsum[1] += s[j][2] + s[j][3];
    }
    l[0] = l[0] * alpha[0] + rowsum[0];
    l[1] = l[1] * alpha[1] + rowsum[1];
#pragma unroll
    for (int i = 0; i < kOTiles; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // acc += P V: the S accumulator fragments re-packed as A fragments.
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = Ops<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = Ops<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = Ops<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = Ops<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < kOTiles; i += 2) {
        // matrices: (kv lo, h i*8..), (kv hi, h i*8..), (kv lo, h (i+1)*8..), (kv hi, h (i+1)*8..)
        const int mi = lane / 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, v_tile + (kk * 16 + (mi % 2) * 8 + lane % 8) * kLds + i * 8 + (mi / 2) * 8);
        Ops<T>::mma(acc[i], pa, bf);
        Ops<T>::mma(acc[i + 1], pa, bf + 2);
      }
    }
  }

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
    for (int i = 0; i < kOTiles; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          Ops<T>::pack(acc[i][2 * r] * inv[r], acc[i][2 * r + 1] * inv[r]);
    if (lane % 4 == 0)
      p.lse[((int64_t)b * p.heads + n) * p.seq_q + row] = m[r] * kLn2 + logf(l[r]);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_region0_bytes<T, HD>(p.rope_cos != nullptr) + 4 * kBlockKV * (HD + 8) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_q + 16 * kWarps - 1) / (16 * kWarps), p.heads, batch);
  flash_fwd_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = bf16, 1 = fp16. Strides
// are in elements; the head dim is contiguous. Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         const void* kv_lens, const void* rope_cos, const void* rope_sin,
                         int batch, int heads, int seq_q, int seq_kv, int head_dim, int dtype,
                         int64_t q_sb, int64_t q_sn, int64_t q_ss,
                         int64_t k_sb, int64_t k_sn, int64_t k_ss,
                         int64_t v_sb, int64_t v_sn, int64_t v_ss,
                         int64_t o_sb, int64_t o_sn, int64_t o_ss,
                         int64_t rope_sn, float qscale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_ss = o_ss;
  p.rope_sn = rope_sn;
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) err = launch<__nv_bfloat16, 64>(p, batch, s);
  else if (dtype == 0 && head_dim == 128) err = launch<__nv_bfloat16, 128>(p, batch, s);
  else if (dtype == 1 && head_dim == 64) err = launch<__half, 64>(p, batch, s);
  else if (dtype == 1 && head_dim == 128) err = launch<__half, 128>(p, batch, s);
  return static_cast<int>(err);
}
