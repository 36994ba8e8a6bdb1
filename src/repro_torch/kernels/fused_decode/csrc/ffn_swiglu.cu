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
// (270.5 MB, 0.081 ms at the 7B width). Design: oproj_ffn_swiglu.cu's
// gate/up and down weight streams (ffn_passes.cuh), after rms_prep.cuh's
// first pass in place of the out-projection: x's per-tile squares and x *
// scale as the gate/up activation. Three launches, chained by programmatic
// dependent launch.
#include "ffn_passes.cuh"

using namespace repro;

extern "C" int ffn_swiglu_bf16(const void* x, const void* scale,
                               const void* wg, const void* wu, const void* wd,
                               void* out, void* ws, const long long* plan,
                               int residual, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lanes(plan[PL_NL], [&](auto L) {
    constexpr int NL = decltype(L)::value;
    FfnStreams<NL> ffn;
    if (!ffn.init(plan, ws, wg, wu, wd))
      return static_cast<int>(cudaErrorInvalidValue);
    const bf16* xb = static_cast<const bf16*>(x);
    const int rc = launch_rms_prep<NL>(
        xb, static_cast<const bf16*>(scale), at<float>(ws, plan, PL_SS),
        at<bf16>(ws, plan, PL_IMG_G), plan[PL_B], plan[PL_D], s);
    if (rc) return rc;
    return ffn.launch(plan, ws, out, nullptr, residual ? xb : nullptr, s);
  });
}

REPRO_EXPORT_ERROR_STRING
