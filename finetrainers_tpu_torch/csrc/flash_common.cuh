// Device helpers shared by the attention kernels (flash_fwd_sm90.cu: K1,
// flash_bwd_sm90.cu: K2, K3, flash_fwd.cu: K7a-c, flash_bwd.cu: the pre-pass,
// K5, sage_fwd_sm90.cu: K6 and its pre-pass): the bf16/fp16 mma.sync m16n8k16 wrappers, ldmatrix,
// cp.async, the base-2 exponential, the fused interleaved-pair RoPE and its
// transpose. `ops/_build.py` hashes every header of csrc/ into each library's
// name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
  // x rounded to bf16 and back: the rounding point of a cast to the input dtype.
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
  static __device__ __forceinline__ float round(float x) { return __half2float(__float2half_rn(x)); }
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading `src`.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rotate (interleaved pairs, as _rope_fwd: y[2i] = c*x[2i] - s*x[2i+1],
// y[2i+1] = c*x[2i+1] + s*x[2i]) and/or scale 8 values held as 16 bytes of T,
// in fp32, then round back to T. `cos`/`sin` point at the 8 matching fp32
// table entries, or are nullptr for no rotation.
template <typename T>
__device__ __forceinline__ uint4 rope_scale_8(uint4 val, const float* cos, const float* sin, float mul) {
  uint32_t w[4] = {val.x, val.y, val.z, val.w};
  float x[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = Ops<T>::unpack(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
  if (cos != nullptr) {
    const float4 c0 = reinterpret_cast<const float4*>(cos)[0], c1 = reinterpret_cast<const float4*>(cos)[1];
    const float4 s0 = reinterpret_cast<const float4*>(sin)[0], s1 = reinterpret_cast<const float4*>(sin)[1];
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[2 * i], x1 = x[2 * i + 1];
      x[2 * i] = x0 * cv[2 * i] - x1 * sv[2 * i];
      x[2 * i + 1] = x1 * cv[2 * i + 1] + x0 * sv[2 * i + 1];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = Ops<T>::pack(x[2 * i] * mul, x[2 * i + 1] * mul);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The transpose rotation of one (even, odd) column pair of a gradient, in
// fp32: y[2i] = g[2i]*c + g[2i+1]*s, y[2i+1] = g[2i+1]*c' - g[2i]*s'
// (`_rope_bwd`: g*cos - rotate(g)*sin). `cos`/`sin` point at the pair's entries.
__device__ __forceinline__ float2 rope_bwd_pair(float g0, float g1, const float* cos, const float* sin) {
  const float2 c = *reinterpret_cast<const float2*>(cos);
  const float2 s = *reinterpret_cast<const float2*>(sin);
  return make_float2(g0 * c.x + g1 * s.x, g1 * c.y - g0 * s.y);
}

// Start the asynchronous copy of a ROWS-row tile of a (S, HD) slice with row
// stride `ss` into shared memory with row stride HD + 8; rows at or past
// `rows_valid` are zero-filled.
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile_async(T* dst, const T* src, int64_t ss, int rows_valid) {
  constexpr int kVecPerRow = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * kVecPerRow; idx += THREADS) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    const bool valid = r < rows_valid;
    cp_async_16(dst + r * (HD + 8) + c, valid ? src + r * ss + c : src, valid);
  }
}

}  // namespace
