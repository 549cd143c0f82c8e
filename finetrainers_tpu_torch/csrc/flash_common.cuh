// Device helpers shared by the attention kernels (flash_fwd_sm90.cu: K1 and
// K7a-c, flash_bwd_sm90.cu: K2, K3, K5, flash_bwd.cu: the pre-pass, K5's dq
// emit, sage_fwd_sm90.cu: K6 and its pre-pass): bf16/fp16 packing and rounding,
// the base-2 exponential, the fused interleaved-pair RoPE and its transpose.
// `ops/_build.py` hashes every header of csrc/ into each library's name, so an
// edit here rebuilds them all.

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
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

}  // namespace
