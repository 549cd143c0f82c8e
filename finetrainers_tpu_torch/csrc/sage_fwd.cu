// INT8 SageAttention forward (K6) for Hopper (sm_90a), CUDA C++ with mma.sync.
//
// Replaces: finetrainers_tpu/ops/sage_attention.py::_sage_fwd_kernel (Pallas,
// TPU), driven there by _sage_impl. It computes the same function on the
// quantized operands that the pre-pass (ops/sage_attention.py, torch ops, as
// the JAX package computes it in XLA) hands over: per-token int8 codes of q and
// of the smoothed k with their fp32 scales, v in bf16/fp16 and an optional
// per-batch kv_lens prefix. S = float(q8 k8^T) * qs * ks * scale, an fp32
// online softmax, P V accumulated in fp32; rows with no valid key give exact
// zeros. No causal branch, no mask beyond kv_lens (the Pallas kernel has none).
//
// What bounds it on this card: at the Wan 2.1 self-attention shape (B=2,
// N=12, S=19968, H=128) QK^T is 2*B*N*S*S*H = 2.45 TOP in int8 and P V 2.45
// TFLOP in bf16, against ~370 MB of codes, scales, v and out: ~13,000
// operations per byte, so the tensor cores bound it (1.24 ms of int8 at 1,979
// TOP/s plus 2.48 ms of bf16 at 989 TFLOP/s).
//
// What this design does about it (right first, not yet fast): both products
// run on the tensor cores, QK^T as mma.sync m16n8k32 s8*s8->s32 (twice the
// bf16 rate) and P V as m16n8k16 bf16/fp16 with fp32 accumulation. The int8
// operands load with the same ldmatrix as K1's bf16 ones: an 8x8 b16 matrix is
// an 8-row, 16-byte int8 block, and the s8 fragments of m16n8k32 hold 4 bytes
// per register in the positions the b16 fragments of m16n8k16 hold 2 values.
// The S tile never leaves registers: it is dequantised there with the per-row
// q scale (scale*log2e folded in, so the softmax uses exp2) and the per-column
// k scale, and its accumulator layout is K1's, so the softmax and the P V
// re-pack are K1's. p is rounded to v's dtype before P V (the JAX kernel keeps
// it fp32: the one deliberate difference). One CTA of 8 warps owns a 128-row q
// tile of one (batch, head) and loops over 64-row kv tiles up to kv_lens[b];
// the next k, v and k-scale tiles are fetched with cp.async while the current
// one is computed. Not yet used: wgmma, TMA, warp specialisation.

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 8;  // each warp owns 16 q rows
constexpr int kBlockKV = 64;

struct Params {
  const int8_t* q;   // (B, N, Sq, H) codes, strided
  const int8_t* k;   // (B, N, Skv, H) codes, strided
  const float* qs;   // (B, N, Sq) scales, strided
  const float* ks;   // (B, N, Skv) scales, strided
  const void* v;     // (B, N, Skv, H) bf16/fp16, strided
  void* out;         // (B, N, Sq, H) in v's dtype, strided
  const int* kv_lens;  // (B,) or nullptr
  int heads, seq_q, seq_kv;
  int64_t q_sb, q_sn, q_ss;
  int64_t k_sb, k_sn, k_ss;
  int64_t qs_sb, qs_sn, qs_ss;
  int64_t ks_sb, ks_sn, ks_ss;
  int64_t v_sb, v_sn, v_ss;
  int64_t o_sb, o_sn, o_ss;
  float qscale;  // softmax scale * log2(e)
};

__device__ __forceinline__ void mma_s8(int32_t* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start the asynchronous copy of a ROWS-row tile of int8 codes (rows of HD
// bytes with row stride `ss`) into shared memory with row stride HD + 16
// bytes; rows at or past `rows_valid` are zero-filled.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void copy_codes_async(int8_t* dst, const int8_t* src, int64_t ss, int rows_valid) {
  constexpr int kVecPerRow = HD / 16;
  for (int idx = threadIdx.x; idx < ROWS * kVecPerRow; idx += THREADS) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 16;
    const bool valid = r < rows_valid;
    cp_async_16(dst + r * (HD + 16) + c, valid ? src + r * ss + c : src, valid);
  }
}

// Start the asynchronous copy of the kBlockKV k scales of a kv tile (stride
// `ss`); scales at or past `rows_valid` are zero-filled.
template <int THREADS>
__device__ __forceinline__ void copy_scales_async(float* dst, const float* src, int64_t ss, int rows_valid) {
  for (int r = threadIdx.x; r < kBlockKV; r += THREADS) {
    const bool valid = r < rows_valid;
    cp_async_4(dst + r, valid ? src + r * ss : src, valid);
  }
}

template <int HD>
__host__ __device__ constexpr int smem_bytes(int v_elem_bytes) {
  return 16 * kWarps * (HD + 16)                  // q codes
         + 2 * kBlockKV * (HD + 16)               // two k code tiles
         + 2 * kBlockKV * (HD + 8) * v_elem_bytes  // two v tiles
         + 2 * kBlockKV * 4;                      // two k scale tiles
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) sage_fwd_kernel(const Params p) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kBlockQ = 16 * kWarps;
  constexpr int kLdc = HD + 16;          // code row stride in shared memory, bytes
  constexpr int kLdv = HD + 8;           // v row stride in shared memory, elements
  constexpr int kKSteps = HD / 32;       // k-steps of QK^T over the head dim
  constexpr int kSTiles = kBlockKV / 8;  // n-tiles of the S tile
  constexpr int kOTiles = HD / 8;        // n-tiles of the output accumulator

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_k = s_q + kBlockQ * kLdc;                                  // two k tiles
  T* s_v = reinterpret_cast<T*>(s_k + 2 * kBlockKV * kLdc);             // two v tiles
  float* s_ks = reinterpret_cast<float*>(s_v + 2 * kBlockKV * kLdv);   // two k scale tiles

  const int q0 = blockIdx.x * kBlockQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int8_t* q = p.q + b * p.q_sb + n * p.q_sn;
  const int8_t* k = p.k + b * p.k_sb + n * p.k_sn;
  const float* qs = p.qs + b * p.qs_sb + n * p.qs_sn;
  const float* ks = p.ks + b * p.ks_sb + n * p.ks_sn;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn;
  T* o = static_cast<T*>(p.out) + b * p.o_sb + n * p.o_sn;

  int kv_len = p.seq_kv;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.seq_kv);
  const int num_tiles = (kv_len + kBlockKV - 1) / kBlockKV;

  copy_codes_async<HD, kBlockQ, kThreads>(s_q, q + (int64_t)q0 * p.q_ss, p.q_ss, p.seq_q - q0);
  if (num_tiles > 0) {
    copy_codes_async<HD, kBlockKV, kThreads>(s_k, k, p.k_ss, kv_len);
    copy_tile_async<T, HD, kBlockKV, kThreads>(s_v, v, p.v_ss, kv_len);
    copy_scales_async<kThreads>(s_ks, ks, p.ks_ss, kv_len);
  }
  cp_async_commit();

  // Each thread holds two rows: lane/4 (fragment slots 0,1) and lane/4+8 (slots 2,3).
  const int row0 = q0 + warp * 16 + lane / 4;
  float qrow[2];  // per-row q scale * softmax scale * log2(e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    qrow[r] = row < p.seq_q ? qs[row * p.qs_ss] * p.qscale : 0.f;
  }

  cp_async_wait_all();
  __syncthreads();
  // This warp's 16 q rows as s8 A fragments, kept in registers for the kv loop.
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldmatrix_x4(qf[kk], s_q + (warp * 16 + (lane % 16)) * kLdc + kk * 32 + (lane / 16) * 16);

  float acc[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced over the quad at the end

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBlockKV;
    const int8_t* k_tile = s_k + (t & 1) * kBlockKV * kLdc;
    const T* v_tile = s_v + (t & 1) * kBlockKV * kLdv;
    const float* ks_tile = s_ks + (t & 1) * kBlockKV;
    cp_async_wait_all();  // this thread's pieces of tile t have landed
    // Tile t is visible to every warp; every warp is done with tile t-1's
    // buffers, which the prefetch below overwrites.
    __syncthreads();
    if (t + 1 < num_tiles) {
      const int k1 = k0 + kBlockKV;
      const int nb = (t + 1) & 1;
      copy_codes_async<HD, kBlockKV, kThreads>(s_k + nb * kBlockKV * kLdc, k + (int64_t)k1 * p.k_ss, p.k_ss,
                                               kv_len - k1);
      copy_tile_async<T, HD, kBlockKV, kThreads>(s_v + nb * kBlockKV * kLdv, v + (int64_t)k1 * p.v_ss, p.v_ss,
                                                 kv_len - k1);
      copy_scales_async<kThreads>(s_ks + nb * kBlockKV, ks + (int64_t)k1 * p.ks_ss, p.ks_ss, kv_len - k1);
      cp_async_commit();
    }

    // S = Q K^T in int32 for this warp's 16 rows x 64 kv columns.
    int32_t si[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
        // matrices: (kv j*8.., bytes lo), (kv j*8.., bytes hi), (kv (j+1)*8.., lo), (kv (j+1)*8.., hi)
        const int mi = lane / 8;
        uint32_t bf[4];
        ldmatrix_x4(bf, k_tile + (j * 8 + (mi / 2) * 8 + lane % 8) * kLdc + kk * 32 + (mi % 2) * 16);
        mma_s8(si[j], qf[kk], bf);
        mma_s8(si[j + 1], qf[kk], bf + 2);
      }
    }

    // Dequantise into base-2 logits; columns at or past kv_len are selected
    // to -1e30 before the row max.
    const bool ragged = k0 + kBlockKV > kv_len;
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      const int c = j * 8 + 2 * (lane % 4);
      const float kc[2] = {ks_tile[c], ks_tile[c + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (float)si[j][e] * (qrow[e / 2] * kc[e & 1]);
        if (ragged && k0 + c + (e & 1) >= kv_len) s[j][e] = kNegInf;
      }
    }

    // Online softmax. Every processed tile has at least one valid column, so
    // the new max is finite.
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
      const int c = k0 + j * 8 + 2 * (lane % 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // p = 0 by select for masked columns, as the JAX kernel does.
        s[j][e] = (!ragged || c + (e & 1) < kv_len) ? fast_exp2(s[j][e] - m[e / 2]) : 0.f;
        rowsum[e / 2] += s[j][e];
      }
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

    // acc += P V: the S accumulator fragments re-packed (rounded to T) as A fragments.
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
        ldmatrix_x4_trans(bf, v_tile + (kk * 16 + (mi % 2) * 8 + lane % 8) * kLdv + i * 8 + (mi / 2) * 8);
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
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];  // no valid key: exact zeros (acc is 0 too)
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.seq_q) continue;
    T* orow = o + row * p.o_ss + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < kOTiles; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          Ops<T>::pack(acc[i][2 * r] * inv[r], acc[i][2 * r + 1] * inv[r]);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = smem_bytes<HD>((int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(sage_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_q + 16 * kWarps - 1) / (16 * kWarps), p.heads, batch);
  sage_fwd_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype (of v and out): 0 = bf16,
// 1 = fp16. `strides` holds 18 int64 element strides, (batch, head, seq) for q,
// k, qs, ks, v and out in that order; the head dim of q, k, v and out is
// contiguous. Returns a cudaError_t.
extern "C" int sage_fwd(const void* q, const void* k, const void* qs, const void* ks, const void* v, void* out,
                        const void* kv_lens, int batch, int heads, int seq_q, int seq_kv, int head_dim, int dtype,
                        const int64_t* strides, float qscale, void* stream) {
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.qs = static_cast<const float*>(qs);
  p.ks = static_cast<const float*>(ks);
  p.v = v;
  p.out = out;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_ss = strides[5];
  p.qs_sb = strides[6]; p.qs_sn = strides[7]; p.qs_ss = strides[8];
  p.ks_sb = strides[9]; p.ks_sn = strides[10]; p.ks_ss = strides[11];
  p.v_sb = strides[12]; p.v_sn = strides[13]; p.v_ss = strides[14];
  p.o_sb = strides[15]; p.o_sn = strides[16]; p.o_ss = strides[17];
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) err = launch<__nv_bfloat16, 64>(p, batch, s);
  else if (dtype == 0 && head_dim == 128) err = launch<__nv_bfloat16, 128>(p, batch, s);
  else if (dtype == 1 && head_dim == 64) err = launch<__half, 64>(p, batch, s);
  else if (dtype == 1 && head_dim == 128) err = launch<__half, 128>(p, batch, s);
  return static_cast<int>(err);
}
