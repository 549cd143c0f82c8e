// The pre-pass that rotates and scales q and k once per call for every flash
// backward (K2/K3 and K5, in flash_bwd_sm90.cu) and for the forwards K1, K7a
// and K7c, and K5's dq emit, CUDA C++ for Hopper (sm_90a).
//
// The pre-pass computes q_s = T(rope(q) * scale * log2(e)) and k_r = T(rope(k)),
// T() rounding to the input dtype, in place of the JAX kernels' per-tile
// rotation and q scaling (finetrainers_tpu/ops/flash_attention.py:168-192,
// :961-964, :1268-1271). It moves bytes only: one 16-byte vector of q or k a
// thread, grid-stride.
//
// The emit finishes K5 (`bwd_fused_sm90_kernel`), which adds sum_kv ds k_r
// into an fp32 (B, N, Sq, H) accumulator: dq = T(rope^T(scale * dq_acc)) with
// q's tables, the tail of the Pallas `_bwd_fused_kernel` (:1191), one column
// pair a thread, grid-stride. rope^T is the transpose rotation g*cos -
// rotate(g)*sin (`_rope_bwd`).

#include "flash_common.cuh"

namespace {

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

struct EmitParams {
  const float* dq_acc;    // (B, N, Sq, H) contiguous fp32
  const float* rope_cos;  // (N or 1, Sq, H) contiguous, or nullptr
  const float* rope_sin;
  void* dq;
  int batch, heads, seq_q;
  int64_t dq_sb, dq_sn, dq_ss;
  int64_t rope_sn;
  float scale;  // softmax scale
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
__global__ void __launch_bounds__(256) dq_emit_kernel(const EmitParams p) {
  const int64_t total = (int64_t)p.batch * p.heads * p.seq_q * (HD / 2);
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
cudaError_t launch_dq_emit(const EmitParams& p, cudaStream_t stream) {
  const int64_t blocks = ((int64_t)p.batch * p.heads * p.seq_q * (HD / 2) + 255) / 256;
  dq_emit_kernel<T, HD><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = bf16, 1 = fp16. Strides
// are in elements; the head dim is contiguous. Each returns a cudaError_t.

// The pre-pass: q_out = T(rope(q) * qscale), and k_out = T(rope(k)) when k_out
// is given (then the tables must be too); both written (B, N, S, H) contiguous;
// head_dim 32, 64 or 128.
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
  if (!takes(dtype, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(dtype, head_dim, [&](auto type, auto hd) {
    return launch_prep<typename decltype(type)::type, decltype(hd)::value>(p, s);
  });
}

// K5's emit: dq (strides of dq: batch, head, seq) = T(rope^T(scale * dq_acc))
// with the (N or 1, Sq, H) tables when given; head_dim 32, 64 or 128.
extern "C" int flash_bwd_dq_emit(const void* dq_acc, const void* rope_cos, const void* rope_sin, void* dq, int batch,
                                 int heads, int seq_q, int head_dim, int dtype, int64_t dq_sb, int64_t dq_sn,
                                 int64_t dq_ss, int64_t rope_sn, float scale, void* stream) {
  EmitParams p = {};
  p.dq_acc = static_cast<const float*>(dq_acc);
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.dq = dq;
  p.batch = batch;
  p.heads = heads;
  p.seq_q = seq_q;
  p.dq_sb = dq_sb; p.dq_sn = dq_sn; p.dq_ss = dq_ss;
  p.rope_sn = rope_sn;
  p.scale = scale;
  if (!takes(dtype, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(dtype, head_dim, [&](auto type, auto hd) {
    return launch_dq_emit<typename decltype(type)::type, decltype(hd)::value>(p, s);
  });
}
