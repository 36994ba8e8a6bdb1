// RMSNorm + SwiGLU FFN of the dense-cache decode step on Hopper (sm_90a):
//
//     out = x + SwiGLU(RMSNorm(x)) @ Wd       (residual = 1)
//     out =     SwiGLU(RMSNorm(x)) @ Wd       (residual = 0: the
//                                              tensor-parallel partial form,
//                                              summed across shards before
//                                              the residual add)
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::ffn_swiglu
// (_ffn_kernel), both forms.
//
// Bound: device-memory bytes, the 3 * D * F weight elements read once
// (270.5 MB, 0.081 ms at the 7B width). Design: four launches of
// ffn_core.cuh's passes on one stream - the residual pass with no partial
// sums (y = x in f32, per-chunk squares), gate/up, split-K
// down-projection, residual - i.e. oproj_ffn_swiglu.cu without the
// out-projection.
#include "ffn_core.cuh"

using namespace repro;

extern "C" int ffn_swiglu_bf16(const void* x, const void* scale,
                               const void* wg, const void* wu, const void* wd,
                               void* out, void* y, void* ss, void* h,
                               void* p_d, int B, int D, int F, int splits_d,
                               int residual, void* stream) {
  using T = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  float* ssf = static_cast<float*>(ss);
  const int n_chunks = (D + FFN_CHUNK - 1) / FFN_CHUNK;
  residual_kernel<T><<<dim3(n_chunks, B), FFN_CHUNK, 0, s>>>(
      static_cast<const T*>(x), nullptr, yf, ssf, B, D, 0);
  REPRO_CHECK_LAUNCH();
  return ffn_passes<T>(yf, ssf, static_cast<const T*>(scale),
                       static_cast<const T*>(wg), static_cast<const T*>(wu),
                       static_cast<const T*>(wd), static_cast<T*>(out),
                       static_cast<float*>(h), static_cast<float*>(p_d), B, D,
                       F, splits_d, residual, s);
}

REPRO_EXPORT_ERROR_STRING
