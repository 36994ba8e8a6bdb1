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
// Design: three weight streams of stream_gemm.cuh (TMA ring, wgmma with the
// weights as the 64-row side, one CTA per SM, a deterministic fix-up of
// split column tiles) chained by programmatic dependent launch, so each
// pass's weight loads start while the one ahead drains: OprojPass (y and
// its per-tile squares in the fix-up), GateUpPass (rstd applied to the
// finished sums, SwiGLU), DownPass (the residual add and the cast). See
// ffn_passes.cuh.
#include "ffn_passes.cuh"

using namespace repro;

// ws: the wrapper's workspace; plan: its int64 plan (ffn_passes.cuh
// PlanField); rows past B of attn and of the activations load as zeros.
extern "C" int oproj_ffn_swiglu_bf16(const void* x, const void* attn,
                                     const void* wo, const void* scale,
                                     const void* wg, const void* wu,
                                     const void* wd, void* out, void* ws,
                                     const long long* plan, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lanes(plan[PL_NL], [&](auto L) {
    constexpr int NL = decltype(L)::value;
    const int B = plan[PL_B], D = plan[PL_D], HD = plan[PL_HD];
    FfnStreams<NL> ffn;
    CUtensorMap m_wo, m_attn;
    if (!ffn.init(plan, ws, wg, wu, wd) ||
        !map_rows(&m_wo, wo, HD, D, unit_rows(1)) ||
        !map_rows(&m_attn, attn, B, HD, NL))
      return static_cast<int>(cudaErrorInvalidValue);
    float* y = at<float>(ws, plan, PL_Y);
    const OprojPass<NL> op{static_cast<const bf16*>(x),
                           static_cast<const bf16*>(scale), y,
                           at<float>(ws, plan, PL_SS),
                           at<bf16>(ws, plan, PL_IMG_G), B, D,
                           (D + SG_NT - 1) / SG_NT};
    const int rc = launch_stream(
        m_wo, m_wo, m_wo, m_attn,
        plan_of(plan, HD, D, 1, PL_CTAS_O, PL_MAXS_O),
        at<float>(ws, plan, PL_PART_O), at<int>(ws, plan, PL_CNT_O), op, s);
    if (rc) return rc;
    return ffn.launch(plan, ws, out, y, nullptr, s);
  });
}

REPRO_EXPORT_ERROR_STRING
