// RMSNorm + QKV projection + RoPE at one position for the dense-cache
// decode step, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::qkv_rope (_qkv_kernel).
//
// Computes qkv_core.cuh's two passes against one concatenated
// w_qkv (D, (n_q + 2 n_kv) * dh) = wq | wk | wv, rotating the q and k heads
// at the position `pos` shared by the batch (a host int). With
// rope_frac < 1 only the first rot = 2 * rot2 elements of a head rotate,
// the rest pass through; v heads are not rotated. Output (H, B, dh) in x's
// type, head-major, as the TPU kernel returns it.
//
// Bound: device-memory bytes, the D * H * dh weight elements read once
// (100.7 MB, 0.030 ms at the 7B width). Design: see qkv_core.cuh; head hh
// is the column tile [hh * dh, (hh + 1) * dh) of w_qkv.
#include "qkv_core.cuh"

using namespace repro;

// the functors are named types at file scope: a __global__ template's
// arguments may not be local or unnamed types
template <typename T, int DH>
struct FusedHeads {
  const T* w;
  int Ht;
  __device__ HeadTile<T> operator()(int hh) const {
    return {w, Ht * DH, hh * DH};
  }
};

template <typename T, int DH>
struct HeadMajorOut {        // out (Ht, B, DH), one position for all lanes
  T* o;
  int B, p;
  __device__ int pos(int) const { return p; }
  __device__ T& operator()(int hh, int b, int e) const {
    return o[((size_t)hh * B + b) * DH + e];
  }
};

extern "C" int qkv_rope_bf16(const void* x, const void* scale,
                             const void* w_qkv, const void* inv_freq,
                             void* out, void* partial, int B, int D, int Hq,
                             int Hkv, int dh, int pos, int rot2, int splits,
                             void* stream) {
  using T = __nv_bfloat16;
  const int Ht = Hq + 2 * Hkv;
  return with_head_dim(dh, [&](auto dh_c) {
    constexpr int DH = decltype(dh_c)::value;
    return qkv_rope_launch<T, DH>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        FusedHeads<T, DH>{static_cast<const T*>(w_qkv), Ht},
        static_cast<const float*>(inv_freq),
        HeadMajorOut<T, DH>{static_cast<T*>(out), B, pos},
        static_cast<float*>(partial), B, D, Ht, Hq + Hkv, rot2, splits,
        static_cast<cudaStream_t>(stream));
  });
}

REPRO_EXPORT_ERROR_STRING
