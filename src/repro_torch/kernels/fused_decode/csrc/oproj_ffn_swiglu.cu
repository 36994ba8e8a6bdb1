// The decoder-layer epilogue of the paged decode step on Hopper (sm_90a):
//
//     y   = x + attn @ Wo                     (out-projection + residual)
//     out = y + SwiGLU(RMSNorm(y)) @ Wd       (FFN + residual)
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::oproj_ffn_swiglu
// (_oproj_ffn_kernel).
//
// Bound: device-memory bytes. The weights are Hq*dh*D + 3*D*F elements
// (304 MB in bf16 at the 7B width), read once; at B = 8 the arithmetic is
// 2 * B flops per weight. Least time = weight bytes / 3.35 TB/s.
//
// Design: five launches of ffn_core.cuh's passes on one stream: split-K
// out-projection, residual + per-chunk squares, gate/up, split-K
// down-projection, residual.
#include "ffn_core.cuh"

using namespace repro;

extern "C" int oproj_ffn_swiglu_bf16(const void* x, const void* attn,
                                     const void* wo, const void* scale,
                                     const void* wg, const void* wu,
                                     const void* wd, void* out, void* y,
                                     void* ss, void* h, void* p_o,
                                     void* p_d, int B, int D, int HD, int F,
                                     int splits_o, int splits_d,
                                     void* stream) {
  using T = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int SMEM = a_smem_bytes<FFN_LB, FFN_KC>();
  cudaFuncSetAttribute(splitk_gemm_kernel<T, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  REPRO_CHECK_LAUNCH();
  float* yf = static_cast<float*>(y);
  float* ssf = static_cast<float*>(ss);
  float* po = static_cast<float*>(p_o);
  const int tiles_d = (D + FFN_NT - 1) / FFN_NT;
  const int n_chunks = (D + FFN_CHUNK - 1) / FFN_CHUNK;
  const int kper_o = (HD + splits_o - 1) / splits_o;
  splitk_gemm_kernel<T, T><<<dim3(tiles_d, splits_o), FFN_NTHREADS, SMEM, s>>>(
      static_cast<const T*>(attn), static_cast<const T*>(wo), po, B, HD, D,
      kper_o);
  REPRO_CHECK_LAUNCH();
  residual_kernel<T><<<dim3(n_chunks, B), FFN_CHUNK, 0, s>>>(
      static_cast<const T*>(x), po, yf, ssf, B, D, splits_o);
  REPRO_CHECK_LAUNCH();
  return ffn_passes<T>(yf, ssf, static_cast<const T*>(scale),
                       static_cast<const T*>(wg), static_cast<const T*>(wu),
                       static_cast<const T*>(wd), static_cast<T*>(out),
                       static_cast<float*>(h), static_cast<float*>(p_d), B, D,
                       F, splits_d, 1, s);
}

REPRO_EXPORT_ERROR_STRING
