// Paged GQA flash-decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_decode_paged
// (_decode_paged_kernel), reached through flash_attention/ops.py::decode_paged.
//
// Computes, for every lane b and kv head h, the G grouped queries against
// the lane's cached keys and values, gathered position by position through
// the block table tables[b, t / block] of the paged pools
// (rows, block, Hkv, dh), masked to the first len1[b] positions. A lane
// whose len1 points at padding rows produces finite garbage that the caller
// ignores, as on the TPU.
//
// Bound: device-memory bytes: (K+V bytes of the lanes' len1 + q + out) /
// 3.35 TB/s.
//
// Design: decode_core.cuh's CTA per (lane, kv head) - 256 CTAs at the 7B
// width and B = 8 - with the table lookup in its row functor (no scalar
// prefetch). Split-K across CTAs for contexts far longer than the pool's
// 512 comes later.
#include "decode_core.cuh"

using namespace repro;

namespace {

struct PagedRows {
  const int* tb;          // the lane's block table
  int block;
  size_t tok_stride;      // Hkv * DH
  size_t head_off;        // h * DH
  __device__ size_t operator()(int t) const {
    return ((size_t)tb[t / block] * block + (t % block)) * tok_stride +
           head_off;
  }
};

template <typename T, int DH, int GT, int EPL>
__global__ void __launch_bounds__(DECODE_NWARPS * 32)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ len1, T* __restrict__ out, int Hkv,
                    int block, int maxb, float scale) {
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  int L = len1[b];
  if (L > maxb * block) L = maxb * block;
  const PagedRows rows{tables + (size_t)b * maxb, block, (size_t)Hkv * DH,
                       (size_t)h * DH};
  decode_cta<T, DH, GT, EPL>(q, kp, vp, out, b, h, Hkv, L, scale, rows);
}

}  // namespace

extern "C" int decode_paged_bf16(const void* q, const void* kp, const void* vp,
                                 const void* tables, const void* len1,
                                 void* out, int B, int Hkv, int G, int dh,
                                 int block, int maxb, float scale,
                                 void* stream) {
  using T = __nv_bfloat16;
  return with_head_shape(dh, G, [&](auto dh_c, auto g_c) {
    constexpr int DH = decltype(dh_c)::value, GT = decltype(g_c)::value;
    decode_paged_kernel<T, DH, GT, decode_epl<GT>()>
        <<<B * Hkv, DECODE_NWARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(kp),
            static_cast<const T*>(vp), static_cast<const int*>(tables),
            static_cast<const int*>(len1), static_cast<T*>(out), Hkv, block,
            maxb, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

REPRO_EXPORT_ERROR_STRING
