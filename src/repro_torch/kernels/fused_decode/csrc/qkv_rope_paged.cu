// RMSNorm + per-head Q/K/V projection + per-lane RoPE for the paged decode
// step, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::qkv_rope_paged
// (_qkv_paged_kernel).
//
// Computes qkv_pass.cuh's projection against the native wq (D, Hq, dh),
// wk / wv (D, Hkv, dh) layouts (three tensor maps, no concatenated
// weight), rotating q and k by each lane's own position pos[b]. Outputs q
// (B, Hq, dh), k / v (B, Hkv, dh) in x's type.
//
// Bound: device-memory bytes, D * (Hq + 2 Hkv) * dh weight elements read
// once (100.7 MB, 0.030 ms at the 7B width). Design: see qkv_pass.cuh - the
// first pass, then one weight stream of stream_gemm.cuh over the three
// weights with rstd and RoPE in its epilogue.
#include "qkv_pass.cuh"

using namespace repro;

// ws: the wrapper's workspace; plan: its int64 plan (qkv_pass.cuh
// QkvPlanField). x, pos, q, k and v start at this call's first lane.
extern "C" int qkv_rope_paged_bf16(const void* x, const void* scale,
                                   const void* wq, const void* wk,
                                   const void* wv, const void* pos,
                                   const void* inv_freq, void* q, void* k,
                                   void* v, void* ws, const long long* plan,
                                   void* stream) {
  const int wq_cols = plan[QP_HQ] * plan[QP_DH];
  const int wkv_cols = plan[QP_HKV] * plan[QP_DH];
  const SplitOut out{static_cast<bf16*>(q), static_cast<bf16*>(k),
                     static_cast<bf16*>(v), static_cast<const int*>(pos),
                     wq_cols, wkv_cols};
  return qkv_rope_launch(plan, x, scale, wq, wk, wv, inv_freq, out, ws,
                         static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT_ERROR_STRING
