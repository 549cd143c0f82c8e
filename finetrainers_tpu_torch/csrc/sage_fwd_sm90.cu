// INT8 SageAttention for Hopper (sm_90a), CUDA C++: the pre-pass that rotates,
// smooths and quantizes q and k (`sage_prep`), and K6, a warp-specialised
// kernel whose int8 QK^T and bf16/fp16 P V run on wgmma, fed by TMA through a
// ring of shared-memory stages (`sage_fwd_sm90`).
//
// Replaces: finetrainers_tpu/ops/sage_attention.py::_sage_fwd_kernel (:36;
// Pallas, TPU), driven there by _sage_impl through pallas_call (:136); the
// pre-pass replaces the XLA work around it: the dispatcher's rotation
// (finetrainers_tpu/ops/attention.py:121-135, :207-209), smooth-K (:112-118)
// and _quantize_per_token (:96-103).
//
// The pre-pass, on BTNH q and k (bf16/fp16, strided, H contiguous), with
// optional fp32 (N or 1, S, H) RoPE tables and kv_lens:
//   x = T(rope(x)) (T() rounds to the input dtype; the rotation is torch's
//       x*cos + rotate_pairs(x)*sin, three separately rounded fp32 operations,
//       written with __fmul_rn/__fadd_rn so that nvcc does not contract them
//       into an FMA);
//   k -= mean over the valid prefix s < kv_lens[b], per (b, n, channel), fp32,
//       the shifted k kept fp32;
//   scale = absmax / 127 per token (1 where absmax is 0), code =
//       clamp(round_half_even(x / scale), -127, 127), both IEEE divisions.
// The mean is a reduction over the whole sequence, so it takes passes of its
// own, launched from the same C entry: `sage_prep_sum_kernel` writes k's
// fixed-order fp32 partial sums per chunk of rows, `sage_prep_mean_kernel`
// adds them in a fixed order (no atomics: the codes are the same from run to
// run), and `sage_prep_quant_kernel` then quantizes q and k.
// Layout written: codes (B, N, S, H) int8 contiguous, so that one K6 tile of
// 128 rows is one TMA box; scales (B, N, S) fp32 contiguous, so that one kv
// stage's scales are one run.
//
// K6 computes, on those codes and v (B, N, Skv, H) in bf16/fp16, in base 2,
// the logits f * t with t = float(q8 k8^T) * ks (fp32; the int32 products are
// exact) and the row factor f = qs * scale * log2(e):
//   t selected to -inf at keys >= kv_lens[b] before the row max;
//   m_new = max(m, f * rowmax(t)); p = exp2(f t - m_new), exactly 0 at those
//   keys; alpha = exp2(m - m_new); l = l*alpha + rowsum(p);
//   acc = acc*alpha + T(p) v; out = T(acc / l); a row with no valid key gives
//   exact zeros.
// p is rounded to v's dtype before P V (the JAX kernel keeps it fp32: the one
// deliberate difference, ROADMAP.md section 3).
//
// What bounds them on this card. The pre-pass moves bytes: at Wan's
// self-attention shape (B=2, N=12, S=19,968, H=128) it must read 245 MB of q
// and k and 20 MB of tables and write 123 MB of codes and 4 MB of scales
// (0.117 ms at 3.35 TB/s); the two-pass design also reads k and the tables a
// second time. K6 is bound by operations: QK^T is 2*B*N*S*S*H = 2.45 TOP of
// int8 (1.24 ms at 1,979 TOP/s) and P V 2.45 TFLOP of bf16 (2.48 ms at 989
// TFLOP/s), against ~0.4 GB of codes, scales, v and out.
//
// What this design does about it:
//  - The pre-pass reads q and k once for the codes (k once more for the mean),
//    16 bytes a lane, one row per H/8 lanes, the absmax reduced by shuffles;
//    no fp32 copy of q or k ever reaches device memory. Its instructions are
//    kept few, since it must stream ~0.4 GB in ~0.12 ms: a warp steps through
//    its rows' indices instead of dividing and loads the next row while it
//    quantizes one, and the division by the scale is a multiply by its
//    reciprocal, checked against the rounding boundary (`quantize`), so the
//    codes stay those of the IEEE quotient.
//  - K6 follows K1 (flash_fwd_sm90.cu): warpgroup 0 gives up its registers
//    (setmaxnreg) and its first warp loads, lane 0 issuing every TMA copy; the
//    consumer warpgroups own 64 q rows each (two at H=128 with 240 registers,
//    three at H=64 with 160). The q-code tile is loaded once; a ring of
//    kStages stages holds {k codes, v, k scales} of 128 keys each, up to the
//    last tile that holds a valid key, so dead tiles are never loaded.
//  - QK^T is wgmma m64n128k32 s32.s8.s8 with both operands in shared memory,
//    K-major (8-bit wgmma has no transpose; the codes are row-major over H). A
//    k-step of 32 codes is 32 bytes, the byte step of K1's bf16 k16. At H=128
//    an int8 row is one 128-byte swizzle row, so a tile is one TMA box; at
//    H=64 it is 64 bytes and takes the 64-byte swizzle (8-row groups 512 bytes
//    apart).
//  - The s32 accumulator fragment has the register layout of the f32 one: it
//    is converted in place and multiplied by each column's k scale (the
//    producer's lanes stage a stage's 128 scales in shared memory beside its
//    codes); the row factor rides in the exponent's FMA, so a score costs one
//    instruction more than K1's. (Converting through the float's bits, two
//    ALU operations, and a separate multiply by the row factor both measured
//    slower.) From there K1's online softmax, row sums and packing of p into
//    the register-A fragment of P V (m64nHk16, v MN-major) carry over; at
//    H=128 the accumulator's rescale is skipped where no row's max moved.
//    Tile t's QK^T is issued together with tile t-1's P V, and tile t's
//    softmax runs while that P V is on the tensor cores.
//  - TMA reads the real rows of k, v and scales between kv_lens[b] and S: their
//    scores are selected to -inf before the max, so their p is exactly 0,
//    whatever those rows hold.
//  - The consumer warpgroups take turns, in a ring, to issue their products
//    (named barriers: `turn_wait`, `turn_pass`), so that one's softmax runs
//    under the others' tensor work.
// Not yet used: a persistent grid, a TMA store of the output.

#include "sm90_common.cuh"

namespace {

// ---------------------------------------------------------------- the pre-pass

struct PrepParams {
  const void* q;            // (B, Sq, N, H) strided
  const void* k;            // (B, Skv, N, H) strided
  const int* kv_lens;       // (B,) or nullptr
  const float* rope_cos;    // (N or 1, S, H) contiguous, or nullptr
  const float* rope_sin;
  int8_t* q_codes;          // (B, N, Sq, H) contiguous
  int8_t* k_codes;          // (B, N, Skv, H) contiguous
  float* q_scales;          // (B, N, Sq) contiguous
  float* k_scales;          // (B, N, Skv) contiguous
  float* partials;          // (B, N, chunks, H): k's sums over each chunk of sum_rows rows
  float* mean;              // (B, N, H): k's mean over the valid prefix
  int batch, heads, seq_q, seq_kv, chunks, sum_rows;
  int64_t q_sb, q_sn, q_ss;
  int64_t k_sb, k_sn, k_ss;
  int64_t rope_sn;
};

__device__ __forceinline__ int prep_kv_length(const PrepParams& p, int b) {
  return p.kv_lens != nullptr ? min(max(p.kv_lens[b], 0), p.seq_kv) : p.seq_kv;
}

// 8 values of T (the 16 bytes `val`) as fp32 in x, rotated when `cos` is set
// (the 8 matching table entries) and then rounded to T: y[2i] = x[2i]*c -
// x[2i+1]*s, y[2i+1] = x[2i+1]*c' + x[2i]*s', each product and the sum
// rounded on its own, as torch rounds x*cos + rotate_pairs(x)*sin.
template <typename T>
__device__ __forceinline__ void rotated_8(float* x, uint4 val, const float* cos, const float* sin) {
  const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = Ops<T>::unpack(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
  if (cos == nullptr) return;
  const float4 c0 = reinterpret_cast<const float4*>(cos)[0], c1 = reinterpret_cast<const float4*>(cos)[1];
  const float4 s0 = reinterpret_cast<const float4*>(sin)[0], s1 = reinterpret_cast<const float4*>(sin)[1];
  const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = x[2 * i], x1 = x[2 * i + 1];
    x[2 * i] = Ops<T>::round(__fadd_rn(__fmul_rn(x0, cv[2 * i]), -__fmul_rn(x1, sv[2 * i])));
    x[2 * i + 1] = Ops<T>::round(__fadd_rn(__fmul_rn(x1, cv[2 * i + 1]), __fmul_rn(x0, sv[2 * i + 1])));
  }
}

// The table entries of row s, columns c.., of head n (nullptr without tables).
__device__ __forceinline__ const float* table_at(const float* table, const PrepParams& p, int n, int s, int c,
                                                 int hd) {
  return table == nullptr ? nullptr : table + n * p.rope_sn + (int64_t)s * hd + c;
}

// k's fp32 sums over chunk blockIdx.x (rows [chunk * sum_rows, ...) below
// kv_lens[b]) of head (blockIdx.z, blockIdx.y): each thread sums its 8
// channels over every (256 / (HD/8))-th row in order, then thread h adds the
// row lanes' sums of channel h in order. A chunk past kv_lens[b] is never read.
template <typename T, int HD>
__global__ void __launch_bounds__(256) sage_prep_sum_kernel(const PrepParams p) {
  constexpr int kVecs = HD / 8;
  constexpr int kRowLanes = 256 / kVecs;
  __shared__ float part[kRowLanes][HD];
  const int chunk = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kv_len = prep_kv_length(p, b);
  const int r0 = chunk * p.sum_rows;
  if (r0 >= kv_len) return;
  const int r1 = min(r0 + p.sum_rows, kv_len);
  const int c = (threadIdx.x % kVecs) * 8, lane_row = threadIdx.x / kVecs;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn + c;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = r0 + lane_row; s < r1; s += kRowLanes) {
    float x[8];
    rotated_8<T>(x, *reinterpret_cast<const uint4*>(k + s * p.k_ss), table_at(p.rope_cos, p, n, s, c, HD),
                 table_at(p.rope_sin, p, n, s, c, HD));
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += x[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[lane_row][c + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < HD) {
    float sum = 0.f;
#pragma unroll 4
    for (int r = 0; r < kRowLanes; ++r) sum += part[r][threadIdx.x];
    p.partials[(((int64_t)b * p.heads + n) * p.chunks + chunk) * HD + threadIdx.x] = sum;
  }
}

// k's mean of head (blockIdx.y, blockIdx.x), channel threadIdx.x % hd: group
// g = threadIdx.x / hd of kMeanGroups adds the chunk sums g, g + kMeanGroups,
// ... in order, then the group sums are added in group order, over
// max(kv_lens[b], 1).
constexpr int kMeanGroups = 8;
__global__ void __launch_bounds__(kMeanGroups * 128) sage_prep_mean_kernel(const PrepParams p, int hd) {
  __shared__ float part[kMeanGroups][128];
  const int n = blockIdx.x, b = blockIdx.y, h = threadIdx.x % hd, group = threadIdx.x / hd;
  const int kv_len = prep_kv_length(p, b);
  const int used = (kv_len + p.sum_rows - 1) / p.sum_rows;
  const float* chunk_sums = p.partials + ((int64_t)b * p.heads + n) * p.chunks * hd + h;
  float sum = 0.f;
#pragma unroll 4
  for (int c = group; c < used; c += kMeanGroups) sum += chunk_sums[(int64_t)c * hd];
  part[group][h] = sum;
  __syncthreads();
  if (group == 0) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kMeanGroups; ++g) total += part[g][h];
    p.mean[((int64_t)b * p.heads + n) * hd + h] = __fdiv_rn(total, (float)max(kv_len, 1));
  }
}

// The int8 code clamp(round_half_even(x / scale), -127, 127), with x / scale
// the IEEE quotient (as torch and XLA divide), |x| <= 127 * scale. x * inv,
// inv the correctly rounded 1 / scale, lies within 3e-5 of that quotient, so
// it rounds to the same integer unless it lies within 1e-4 of a half-integer:
// only there, and for scales so small that inv overflows, is the division
// made. Rounding adds 1.5 * 2^23 (whose ulp is 1) and reads the integer from
// the bits: full-rate ALU work instead of a division and a conversion (the
// pass measured 3% faster at Wan's shapes than with the division).
__device__ __forceinline__ int quantize(float x, float scale, float inv, bool exact) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  float q = __fmul_rn(x, inv);
  float biased = __fadd_rn(q, kRound);
  if (exact || fabsf(__fsub_rn(q, __fsub_rn(biased, kRound))) > 0.4999f) {
    q = __fdiv_rn(x, scale);
    biased = __fadd_rn(q, kRound);
  }
  return min(max(__float_as_int(biased) - 0x4B400000, -127), 127);
}

// Rows of q or k a warp of the quantization pass takes, kRowsPerWarp at a time.
constexpr int kWarpRows = 32;

// The codes and scales of q (blockIdx.y == 0) or k (1): one row per HD/8
// lanes, 8 values a lane. Rows are taken (b, s, n) with n fastest, so
// that the heads of one position share their table rows in cache; each warp
// owns kWarpRows consecutive rows, whose (b, s, n) it finds by division once
// and then steps (a division a row would cost more than the row's
// arithmetic), loading each row's 16 bytes while it works on the one before.
template <typename T, int HD>
__global__ void __launch_bounds__(256) sage_prep_quant_kernel(const PrepParams p) {
  constexpr int kLanes = HD / 8;
  constexpr int kRowsPerWarp = 32 / kLanes;
  const bool is_k = blockIdx.y == 1;
  const T* src = static_cast<const T*>(is_k ? p.k : p.q);
  int8_t* codes = is_k ? p.k_codes : p.q_codes;
  float* scales = is_k ? p.k_scales : p.q_scales;
  const int seq = is_k ? p.seq_kv : p.seq_q;
  const int64_t sb = is_k ? p.k_sb : p.q_sb, sn = is_k ? p.k_sn : p.q_sn, ss = is_k ? p.k_ss : p.q_ss;
  const int lane = threadIdx.x % 32, c = (lane % kLanes) * 8;
  const int rows = p.batch * seq * p.heads;  // < 2^31, checked by the entry point
  const int first = (blockIdx.x * 8 + threadIdx.x / 32) * kWarpRows;
  if (first >= rows) return;
  const int end = min(first + kWarpRows, rows);
  int row = first + lane / kLanes;
  int n = row % p.heads, s = row / p.heads % seq, b = row / (p.heads * seq);
  uint4 next = make_uint4(0u, 0u, 0u, 0u);
  if (row < end) next = *reinterpret_cast<const uint4*>(src + b * sb + n * sn + s * ss + c);
  for (int row0 = first; row0 < end; row0 += kRowsPerWarp) {
    // This row's 16 bytes have landed or are on their way: start the next row's before working on this one.
    const bool live = row < end;
    const uint4 val = next;
    const int this_n = n, this_s = s, this_b = b;
    row += kRowsPerWarp;
    for (n += kRowsPerWarp; n >= p.heads; n -= p.heads) {
      if (++s == seq) {
        s = 0;
        ++b;
      }
    }
    if (row < end) next = *reinterpret_cast<const uint4*>(src + b * sb + n * sn + s * ss + c);
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      rotated_8<T>(x, val, table_at(p.rope_cos, p, this_n, this_s, c, HD),
                   table_at(p.rope_sin, p, this_n, this_s, c, HD));
      if (is_k) {
        const float* mean = p.mean + ((int64_t)this_b * p.heads + this_n) * HD + c;
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __fsub_rn(x[i], mean[i]);
      }
    }
    float absmax = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) absmax = fmaxf(absmax, fabsf(x[i]));
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
    if (live) {
      const float scale = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
      const float inv = __frcp_rn(scale);
      const bool exact = scale < 1e-30f;
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        packed[i / 4] |= (uint32_t)(quantize(x[i], scale, inv, exact) & 0xff) << (8 * (i % 4));
      const int64_t out_row = ((int64_t)this_b * p.heads + this_n) * seq + this_s;
      *reinterpret_cast<uint2*>(codes + out_row * HD + c) = make_uint2(packed[0], packed[1]);
      if (c == 0) scales[out_row] = scale;
    }
  }
}

template <typename T, int HD>
cudaError_t launch_prep(const PrepParams& p, cudaStream_t stream) {
  sage_prep_sum_kernel<T, HD><<<dim3(p.chunks, p.heads, p.batch), 256, 0, stream>>>(p);
  sage_prep_mean_kernel<<<dim3(p.heads, p.batch), kMeanGroups * HD, 0, stream>>>(p, HD);
  const int64_t rows = (int64_t)p.batch * p.heads * (p.seq_q > p.seq_kv ? p.seq_q : p.seq_kv);
  const int64_t blocks = (rows + 8 * kWarpRows - 1) / (8 * kWarpRows);  // 8 warps a block
  sage_prep_quant_kernel<T, HD><<<dim3((unsigned)blocks, 2), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// -------------------------------------------------------------------------- K6

constexpr int kBlockN = 128;  // keys per stage
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
// Consumer warpgroups per CTA, each owning 64 q rows, and their registers
// after setmaxnreg: as K1 (three at H=64 with 160, two at H=128 with 240).
template <int HD>
__host__ __device__ constexpr int consumer_wgs() {
  return HD == 64 ? 3 : 2;
}
template <int HD>
__host__ __device__ constexpr int block_m() {
  return 64 * consumer_wgs<HD>();
}
template <int HD>
__host__ __device__ constexpr int threads() {
  return 128 * (1 + consumer_wgs<HD>());
}
template <int HD>
__host__ __device__ constexpr int consumer_regs() {
  return HD == 64 ? 160 : 240;
}
constexpr int kHalfBytes = 128 * 128;  // a 64-column half of a 128-row v tile: one TMA box

// Byte offsets in shared memory (from a 1024-byte aligned base): the q-code
// tile, kStages k-code tiles, kStages v tiles, kStages rows of k scales, then
// the barriers q_full, k_full[kStages], v_full[kStages], k_empty[kStages],
// v_empty[kStages]. An int8 code row is HD bytes: one box of HD columns.
template <int HD>
struct Layout {
  static constexpr int kQBytes = block_m<HD>() * HD;
  static constexpr int kKBytes = kBlockN * HD;
  static constexpr int kVBytes = HD / 64 * kHalfBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kScales = kV + kStages * kVBytes;
  static constexpr int kBars = kScales + kStages * kBlockN * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
  static_assert(kK % 1024 == 0 && kV % 1024 == 0, "swizzled tiles must start 1024-byte aligned");
};

// The descriptor of K-major int8 codes, rows of HD bytes: the 128-byte swizzle
// at HD=128 (8-row groups 1024 bytes apart), the 64-byte one at HD=64 (512
// apart). A k-step of 32 codes moves the start 32 bytes inside the row.
template <int HD>
__device__ __forceinline__ uint64_t code_desc(uint32_t addr) {
  return HD == 128 ? smem_desc(addr, 16, 1024, 1) : smem_desc(addr, 16, 512, 2);
}

// d (64 x 128, s32) = A B^T over HD codes: A's 64 rows at `a_addr`, B's 128
// at `b_addr`. Issued, not waited for.
template <int HD>
__device__ __forceinline__ void issue_qk(int32_t* d, uint32_t a_addr, uint32_t b_addr) {
  const uint64_t a = code_desc<HD>(a_addr), b = code_desc<HD>(b_addr);
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk) wgmma_s8_n128(d, a + 2 * kk, b + 2 * kk, kk);
}

// The consumer warpgroups take turns to issue their products, in a ring:
// warpgroup cwg waits on named barrier 1 + cwg, issues, then lets the next
// one go. So one warpgroup's softmax runs while the others' products hold the
// tensor cores (measured 3-8% faster than letting them contend). Each barrier
// counts the 128 threads that wait on it and the 128 that let them go.
__device__ __forceinline__ void turn_wait(int cwg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cwg) : "memory");
}
__device__ __forceinline__ void turn_pass(int next) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + next) : "memory");
}

struct Params {
  void* out;
  const float* q_scales;  // (B, N, Sq) contiguous
  const float* k_scales;  // (B, N, Skv) contiguous
  const int* kv_lens;     // (B,) or nullptr
  int heads, seq_q, seq_kv;
  int64_t o_sb, o_sn, o_ss;
  float qscale;  // softmax scale * log2(e)
};

// The producer, warp 0: the q-code tile once, then tile t's k codes, v and k
// scales into stage t % kStages once the consumers have released it. Lane 0
// issues the TMA copies; every lane stages 4 of the tile's 128 scales (0 past
// Skv). A k_full barrier completes on lane 0's expect-tx arrival, the 32
// lanes' arrivals after their stores, and the TMA bytes.
template <int HD>
__device__ __forceinline__ void produce(const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        const Params& p, uint32_t base, unsigned char* smem, int q0, int n, int b,
                                        int num_tiles) {
  using L = Layout<HD>;
  const int lane = threadIdx.x % 32;
  const uint32_t q_full = base + L::kBars;
  if (lane == 0) {
    mbar_expect_tx(q_full, L::kQBytes);
    tma_load(base + L::kQ, q_map, q_full, 0, q0, n, b);
  }
  const float* ks = p.k_scales + ((int64_t)b * p.heads + n) * p.seq_kv;
  for (int t = 0; t < num_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = ((t / kStages) & 1) ^ 1;  // the first round finds every stage free
    const uint32_t k_full = q_full + 8 * (1 + st), v_full = k_full + 8 * kStages;
    const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;
    float kc[kBlockN / 32];
#pragma unroll
    for (int r = 0; r < kBlockN / 32; ++r) {  // loaded before the wait, so the wait hides their latency
      const int col = t * kBlockN + lane + 32 * r;
      kc[r] = col < p.seq_kv ? ks[col] : 0.f;
    }
    mbar_wait(k_empty, parity);
    if (lane == 0) {
      mbar_expect_tx(k_full, L::kKBytes);
      tma_load(base + L::kK + st * L::kKBytes, k_map, k_full, 0, t * kBlockN, n, b);
    }
    float* s_ks = reinterpret_cast<float*>(smem + L::kScales) + st * kBlockN;
#pragma unroll
    for (int r = 0; r < kBlockN / 32; ++r) s_ks[lane + 32 * r] = kc[r];
    mbar_arrive(k_full);
    mbar_wait(v_empty, parity);
    if (lane == 0) {
      mbar_expect_tx(v_full, L::kVBytes);
#pragma unroll
      for (int h = 0; h < HD / 64; ++h)
        tma_load(base + L::kV + st * L::kVBytes + h * kHalfBytes, v_map, v_full, h * 64, t * kBlockN, n, b);
    }
  }
}

// The online-softmax step (base 2) on a landed s32 score fragment of a
// consumer warpgroup, whose thread holds rows lane/4 and lane/4 + 8 of its
// warp's 16 (element 4j+e at column 8j + 2*(lane%4) + (e&1) of row
// lane/4 + 8*(e>=2)). The logits are f * t with t = float(acc) * ks[col] (the
// conversion is exact: |acc| <= 127^2 * 128 < 2^24) and this thread's row
// factors f > 0 (q scale * softmax scale * log2(e)), so f rides in the
// exponent's FMA. Keys at or past kv_len are selected to t = -inf before the
// row max, so their p = exp2(-inf) is exactly 0; the tile holds at least one
// valid key, so the max is finite. The running max m is moved on, the
// fragment is overwritten by p = exp2(f t - m) in s, and the rescale alpha and
// this tile's row sums are returned.
__device__ __forceinline__ void softmax_step(float* s, const int32_t* acc, const float* ks, const float* f, float* m,
                                             float* alpha, float* rowsum, int k0, int kv_len, int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 kc = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = (float)acc[4 * j + e] * ((e & 1) ? kc.y : kc.x);
  }
  if (k0 + kBlockN > kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= kv_len) s[i] = -INFINITY;
    }
  }
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    tmax[0] = fmaxf(tmax[0], fmaxf(s[4 * j], s[4 * j + 1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], f[r] * tmax[r]);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    rowsum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(fmaf(s[i], f[(i >> 1) & 1], neg_m[(i >> 1) & 1]));
    rowsum[(i >> 1) & 1] += s[i];
  }
}

// A consumer warpgroup (`cwg` 0, 1 or 2) owning q rows q0 + 64*cwg ..., each
// thread two of them (row0 and row0 + 8) in the wgmma accumulator layout, as
// K1's consumer. Tile t's QK^T is issued together with tile t-1's P V; tile t's
// k stage is released once its softmax step has read the stage's k scales.
template <typename T, int HD>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, const unsigned char* smem, int cwg, int q0,
                                        int n, int b, int kv_len, int num_tiles) {
  using L = Layout<HD>;
  constexpr int kOut = HD / 2;  // accumulator floats per thread: 64 rows x HD / 128 threads
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * kStages + st); };
  auto k_scales = [&](int st) { return reinterpret_cast<const float*>(smem + L::kScales) + st * kBlockN; };

  const int row0 = q0 + cwg * 64 + warp * 16 + lane / 4;
  const float* qs = p.q_scales + ((int64_t)b * p.heads + n) * p.seq_q;
  float qrow[2];  // q scale * softmax scale * log2(e) of this thread's rows (1 past Sq: never stored)
#pragma unroll
  for (int r = 0; r < 2; ++r) qrow[r] = row0 + 8 * r < p.seq_q ? qs[row0 + 8 * r] * p.qscale : 1.f;

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced over the quad at the end

  const uint32_t q_addr = base + L::kQ + cwg * 64 * HD;
  mbar_wait(q_full, 0);
  const int next = (cwg + 1) % consumer_wgs<HD>();
  if (num_tiles > 0) {
    int32_t acc[64];
    float s[64], alpha[2], rowsum[2];
    uint32_t pa[kBlockN / 16][4];
    if (next == 0) turn_pass(0);  // warpgroup 0 goes first
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    turn_wait(cwg);
    issue_qk<HD>(acc, q_addr, base + L::kK);
    wgmma_commit();
    turn_pass(next);
    wgmma_wait_all();
    fence_regs<64>(acc);
    softmax_step(s, acc, k_scales(0), qrow, m, alpha, rowsum, 0, kv_len, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(0));
    l[0] = rowsum[0];
    l[1] = rowsum[1];
    pack_a<T, kBlockN>(pa, s);
    for (int t = 1; t < num_tiles; ++t) {
      const int st = t % kStages, prev = (t - 1) % kStages;
      mbar_wait(k_full(st), (t / kStages) & 1);
      fence_regs<kOut>(o);
      wgmma_fence();
      turn_wait(cwg);
      issue_qk<HD>(acc, q_addr, base + L::kK + st * L::kKBytes);
      wgmma_commit();
      mbar_wait(v_full(prev), ((t - 1) / kStages) & 1);
      issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, base + L::kV + prev * L::kVBytes);
      wgmma_commit();
      turn_pass(next);
      wgmma_wait_one();  // QK^T of tile t has landed; P V of tile t-1 may still run
      fence_regs<64>(acc);
      softmax_step(s, acc, k_scales(st), qrow, m, alpha, rowsum, t * kBlockN, kv_len, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(st));
      wgmma_wait_all();
      fence_regs<kOut>(o);
      fence_regs<kBlockN / 16>(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(prev));
      // At H=128 the 64 rescales are skipped where neither row's max moved
      // (alpha is exactly 1, so nothing changes): 6-9% faster at Wan's shape.
      // At H=64 the test costs more than the 32 multiplies it would save.
      if (HD == 64 || alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int i = 0; i < kOut; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      l[0] = l[0] * alpha[0] + rowsum[0];
      l[1] = l[1] * alpha[1] + rowsum[1];
      pack_a<T, kBlockN>(pa, s);
    }
    const int last = (num_tiles - 1) % kStages;
    mbar_wait(v_full(last), ((num_tiles - 1) / kStages) & 1);
    fence_regs<kOut>(o);
    wgmma_fence();
    turn_wait(cwg);
    issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, base + L::kV + last * L::kVBytes);
    wgmma_commit();
    turn_pass(next);
    wgmma_wait_all();
    fence_regs<kOut>(o);
    fence_regs<kBlockN / 16>(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(last));
  }

  // out = acc / l in T; a row with no valid key has l = 0 and acc = 0: exact zeros.
  T* out = static_cast<T*>(p.out) + b * p.o_sb + n * p.o_sn;
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
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(threads<HD>(), 1)
    sage_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + Layout<HD>::kBars;
  const int q0 = blockIdx.x * block_m<HD>(), n = blockIdx.y, b = blockIdx.z;
  int kv_len = p.seq_kv;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.seq_kv);
  const int num_tiles = (kv_len + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full + 8 * (1 + st), 1 + 32);                                // k_full: lane 0's expect-tx + 32 lanes
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
    if (threadIdx.x < 32) produce<HD>(&q_map, &k_map, &v_map, p, base, smem, q0, n, b, num_tiles);
  } else {
    setmaxnreg_inc<consumer_regs<HD>()>();
    consume<T, HD>(p, base, smem, threadIdx.x / 128 - 1, q0, n, b, kv_len, num_tiles);
  }
}

template <typename T, int HD>
cudaError_t launch_fwd(const CUtensorMap* maps, const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.seq_q + block_m<HD>() - 1) / block_m<HD>(), p.heads, batch);
  static std::atomic<uint64_t> attribute_set{0};
  // + 1024 bytes of slack to align the base to 1024 bytes
  return launch_sm90(sage_fwd_sm90_kernel<T, HD>, attribute_set, grid, threads<HD>(), Layout<HD>::kBytes + 1024,
                     stream, maps[0], maps[1], maps[2], p);
}

// The int8 code map: boxes of one whole HD-byte row by box_rows rows, with the
// swizzle the wgmma descriptor reads (code_desc).
bool encode_codes(CUtensorMap* map, const void* ptr, int head_dim, int seq, int heads, int batch, int box_rows,
                  const int64_t* strides) {
  return encode_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, head_dim,
                    head_dim == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B, head_dim, seq, heads,
                    batch, box_rows, strides[0], strides[1], strides[2]);
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = bf16, 1 = fp16; strides
// in elements; the head dim is contiguous and every operand 16-byte aligned.
// Each returns a cudaError_t (cudaErrorInvalidValue also for arguments the
// kernels do not take, or when a tensor map cannot be encoded).

// The pre-pass. strides: q, k, each (batch, head, seq). `scratch` holds
// batch * heads * (chunks + 1) * head_dim floats, chunks = ceil(seq_kv /
// sum_rows): k's chunk sums, then its means. With tables seq_q == seq_kv, and
// rope_sn is the tables' per-head stride (0 for one table shared by every head).
extern "C" int sage_prep(const void* q, const void* k, const void* kv_lens, const void* rope_cos,
                         const void* rope_sin, void* q_codes, void* k_codes, void* q_scales, void* k_scales,
                         void* scratch, int batch, int heads, int seq_q, int seq_kv, int head_dim, int dtype,
                         const int64_t* strides, int64_t rope_sn, int sum_rows, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1) || sum_rows < 1 || seq_kv < 1 ||
      (rope_cos != nullptr && seq_q != seq_kv) ||
      (int64_t)batch * heads * (seq_q > seq_kv ? seq_q : seq_kv) + 32 * kWarpRows >= (int64_t)1 << 31)
    return cudaErrorInvalidValue;
  PrepParams p;
  p.q = q;
  p.k = k;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.rope_cos = static_cast<const float*>(rope_cos);
  p.rope_sin = static_cast<const float*>(rope_sin);
  p.q_codes = static_cast<int8_t*>(q_codes);
  p.k_codes = static_cast<int8_t*>(k_codes);
  p.q_scales = static_cast<float*>(q_scales);
  p.k_scales = static_cast<float*>(k_scales);
  p.batch = batch;
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.sum_rows = sum_rows;
  p.chunks = (seq_kv + sum_rows - 1) / sum_rows;
  p.partials = static_cast<float*>(scratch);
  p.mean = p.partials + (int64_t)batch * heads * p.chunks * head_dim;
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_ss = strides[5];
  p.rope_sn = rope_sn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_prep<__nv_bfloat16, 64>(p, s);
  if (dtype == 0) return launch_prep<__nv_bfloat16, 128>(p, s);
  if (head_dim == 64) return launch_prep<__half, 64>(p, s);
  return launch_prep<__half, 128>(p, s);
}

// K6. strides: q codes, k codes, v, out, each (batch, head, seq); the codes'
// strides are multiples of 16 (TMA's), the scales (B, N, S) contiguous, v and
// out in `dtype`. qscale: the softmax scale * log2(e).
extern "C" int sage_fwd_sm90(const void* q_codes, const void* k_codes, const void* q_scales, const void* k_scales,
                             const void* v, void* out, const void* kv_lens, int batch, int heads, int seq_q,
                             int seq_kv, int head_dim, int dtype, const int64_t* strides, float qscale, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const int q_rows = head_dim == 64 ? block_m<64>() : block_m<128>();
  CUtensorMap maps[3];
  if (!encode_codes(&maps[0], q_codes, head_dim, seq_q, heads, batch, q_rows, strides) ||
      !encode_codes(&maps[1], k_codes, head_dim, seq_kv, heads, batch, kBlockN, strides + 3) ||
      !encode_operand(&maps[2], v, dtype, head_dim, seq_kv, heads, batch, kBlockN, strides[6], strides[7], strides[8]))
    return cudaErrorInvalidValue;
  Params p;
  p.out = out;
  p.q_scales = static_cast<const float*>(q_scales);
  p.k_scales = static_cast<const float*>(k_scales);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_ss = strides[11];
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_fwd<__nv_bfloat16, 64>(maps, p, batch, s);
  if (dtype == 0) return launch_fwd<__nv_bfloat16, 128>(maps, p, batch, s);
  if (head_dim == 64) return launch_fwd<__half, 64>(maps, p, batch, s);
  return launch_fwd<__half, 128>(maps, p, batch, s);
}
