// Dense-cache GQA flash-decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_decode
// (_decode_kernel), reached through flash_attention/ops.py::decode.
//
// Computes o (B, Hq, dh) for queries q (B, Hq, dh) against the dense caches
// k / v (B, S, Hkv, dh), attending the first `length` positions (one length
// shared by the batch, a host int). Positions at or past `length` are never
// read.
//
// Bound: device-memory bytes: (K+V bytes of B * length positions + q + out)
// / 3.35 TB/s - 537 MB, 0.160 ms at the 7B width, B = 8, length 4096.
//
// Design: decode_core.cuh's CTA per (lane, kv head), which serves the head's
// whole q group (the TPU wrapper vmapped one launch per kv head instead).
// Row (b, t) of kv head h sits at ((b * S + t) * Hkv + h) * dh: one head's
// row is a 256-byte run every Hkv * dh * 2 bytes, read by dh / EPL threads
// with 16-byte loads. At 8 lanes x 32 kv heads the 256 CTAs are all
// resident at once; no split along S.
#include "decode_core.cuh"

using namespace repro;

namespace {

struct DenseRows {
  size_t lane_base;       // b * S * Hkv * DH + h * DH
  size_t tok_stride;      // Hkv * DH
  __device__ size_t operator()(int t) const {
    return lane_base + (size_t)t * tok_stride;
  }
};

template <typename T, int DH, int GT, int EPL>
__global__ void __launch_bounds__(DECODE_NWARPS * 32)
decode_dense_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ out, int S,
                    int Hkv, int length, float scale) {
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int L = length < S ? length : S;
  const size_t tok_stride = (size_t)Hkv * DH;
  const DenseRows rows{(size_t)b * S * tok_stride + (size_t)h * DH,
                       tok_stride};
  decode_cta<T, DH, GT, EPL>(q, kc, vc, out, b, h, Hkv, L, scale, rows);
}

}  // namespace

extern "C" int flash_decode_bf16(const void* q, const void* kc, const void* vc,
                                 void* out, int B, int S, int Hkv, int G,
                                 int dh, int length, float scale,
                                 void* stream) {
  using T = __nv_bfloat16;
  return with_head_shape(dh, G, [&](auto dh_c, auto g_c) {
    constexpr int DH = decltype(dh_c)::value, GT = decltype(g_c)::value;
    decode_dense_kernel<T, DH, GT, decode_epl<GT>()>
        <<<B * Hkv, DECODE_NWARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(kc),
            static_cast<const T*>(vc), static_cast<T*>(out), S, Hkv, length,
            scale);
    return static_cast<int>(cudaGetLastError());
  });
}

REPRO_EXPORT_ERROR_STRING
