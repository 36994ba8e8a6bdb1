// Helpers shared by the port's hand-written kernels: element conversion,
// vector loads, and the error-string entry every kernel library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// VEC consecutive elements of T starting at p (aligned to their total size),
// converted to f32, in one load instruction.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  R r = __ldg(reinterpret_cast<const R*>(p));
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
}

// N consecutive elements (N * sizeof(T) may exceed 16 bytes): loads of at
// most 16 bytes each.
template <typename T, int N>
__device__ __forceinline__ void load_span(const T* p, float (&out)[N]) {
  constexpr int V = (N * sizeof(T) > 16) ? int(16 / sizeof(T)) : N;
#pragma unroll
  for (int c = 0; c < N / V; ++c) {
    float t[V];
    load_vec<T, V>(p + c * V, t);
#pragma unroll
    for (int i = 0; i < V; ++i) out[c * V + i] = t[i];
  }
}

// two floats rounded to bf16 and packed into one 32-bit register, lo first
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace repro

#define REPRO_EXPORT_ERROR_STRING                                  \
  extern "C" const char* repro_error_string(int e) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(e));        \
  }
