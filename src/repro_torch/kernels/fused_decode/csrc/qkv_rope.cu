// RMSNorm + QKV projection + RoPE at one position for the dense-cache
// decode step, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::qkv_rope (_qkv_kernel).
//
// Computes qkv_pass.cuh's projection against one concatenated w_qkv (D,
// (n_q + 2 n_kv) * dh) = wq | wk | wv, rotating the q and k heads at the
// position `pos` shared by the batch (a host int). With rope_frac < 1 only
// the first rot = 2 * rot2 elements of a head rotate, the rest pass
// through; v heads are not rotated. Output (H, B, dh) in x's type,
// head-major, as the TPU kernel returns it.
//
// Bound: device-memory bytes, the D * H * dh weight elements read once
// (100.7 MB, 0.030 ms at the 7B width). Design: see qkv_pass.cuh - the
// first pass, then one weight stream of stream_gemm.cuh over w_qkv with
// rstd and RoPE in its epilogue.
#include "qkv_pass.cuh"

using namespace repro;

// ws: the wrapper's workspace; plan: its int64 plan (qkv_pass.cuh
// QkvPlanField). x starts at this call's first lane, lane0 of the `lanes`
// of out (H, lanes, dh).
extern "C" int qkv_rope_bf16(const void* x, const void* scale,
                             const void* w_qkv, const void* inv_freq,
                             void* out, void* ws, const long long* plan,
                             int pos, int lanes, int lane0, void* stream) {
  const HeadMajorOut o{static_cast<bf16*>(out), lanes, lane0, pos,
                       static_cast<int>(plan[QP_DH]),
                       static_cast<int>(plan[QP_HQ]),
                       static_cast<int>(plan[QP_HKV])};
  return qkv_rope_launch(plan, x, scale, w_qkv, w_qkv, w_qkv, inv_freq, o, ws,
                         static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT_ERROR_STRING
