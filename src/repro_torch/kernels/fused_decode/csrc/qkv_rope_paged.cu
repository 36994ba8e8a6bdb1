// RMSNorm + per-head Q/K/V projection + per-lane RoPE for the paged decode
// step, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::qkv_rope_paged
// (_qkv_paged_kernel).
//
// Computes qkv_core.cuh's two passes against the native wq (D, Hq, dh),
// wk / wv (D, Hkv, dh) layouts (no concatenated weight), rotating q and k
// by each lane's own position pos[b]. Outputs q (B, Hq, dh), k / v
// (B, Hkv, dh) in x's type.
//
// Bound: device-memory bytes, D * (Hq + 2 Hkv) * dh weight elements read
// once (100.7 MB, 0.030 ms at the 7B width). Design: see qkv_core.cuh.
#include "qkv_core.cuh"

using namespace repro;

// the functors are named types at file scope: a __global__ template's
// arguments may not be local or unnamed types
template <typename T, int DH>
struct SplitHeads {          // head hh of wq, then wk, then wv
  const T *wq, *wk, *wv;
  int Hq, Hkv;
  __device__ HeadTile<T> operator()(int hh) const {
    if (hh < Hq) return {wq, Hq * DH, hh * DH};
    if (hh < Hq + Hkv) return {wk, Hkv * DH, (hh - Hq) * DH};
    return {wv, Hkv * DH, (hh - Hq - Hkv) * DH};
  }
};

template <typename T, int DH>
struct SplitOut {            // q (B, Hq, DH), k / v (B, Hkv, DH)
  T *q, *k, *v;
  const int* pos_b;
  int Hq, Hkv;
  __device__ int pos(int b) const { return pos_b[b]; }
  __device__ T& operator()(int hh, int b, int e) const {
    if (hh < Hq) return q[((size_t)b * Hq + hh) * DH + e];
    if (hh < Hq + Hkv) return k[((size_t)b * Hkv + hh - Hq) * DH + e];
    return v[((size_t)b * Hkv + hh - Hq - Hkv) * DH + e];
  }
};

extern "C" int qkv_rope_paged_bf16(const void* x, const void* scale,
                                   const void* wq, const void* wk,
                                   const void* wv, const void* pos,
                                   const void* inv_freq, void* q, void* k,
                                   void* v, void* partial, int B, int D,
                                   int Hq, int Hkv, int dh, int rot2,
                                   int splits, void* stream) {
  using T = __nv_bfloat16;
  return with_head_dim(dh, [&](auto dh_c) {
    constexpr int DH = decltype(dh_c)::value;
    const SplitHeads<T, DH> heads{static_cast<const T*>(wq),
                                  static_cast<const T*>(wk),
                                  static_cast<const T*>(wv), Hq, Hkv};
    const SplitOut<T, DH> out{static_cast<T*>(q), static_cast<T*>(k),
                              static_cast<T*>(v),
                              static_cast<const int*>(pos), Hq, Hkv};
    return qkv_rope_launch<T, DH>(
        static_cast<const T*>(x), static_cast<const T*>(scale), heads,
        static_cast<const float*>(inv_freq), out,
        static_cast<float*>(partial), B, D, Hq + 2 * Hkv, Hq + Hkv, rot2,
        splits, static_cast<cudaStream_t>(stream));
  });
}

REPRO_EXPORT_ERROR_STRING
