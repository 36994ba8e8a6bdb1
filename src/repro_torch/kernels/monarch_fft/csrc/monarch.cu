// The fused Monarch pass (paper Fig. 3) for Hopper (sm_90a):
//
//     Z[b] = W1 . ((W0 . x[b]) (*) tw)^T        x (B, N1, N2) -> Z (B, N2, N1)
//
// Replaces: src/repro/kernels/monarch_fft/kernel.py::monarch_fused
// (_monarch_kernel), reached through monarch_fft/ops.py::monarch.
//
// Bound: tensor-core operations. 4 * B * N1 * N2 * (N1 + N2) / 2 flops (two
// products) against x, the three factors and Z read or written once: at
// the paper's 1M-point shape (16, 1024, 1024) 6.87e10 flops and 73.4 MB,
// 0.0695 ms at 989 TFLOP/s (0.022 ms of bytes).
//
// Design: phases 1 and 2 of monarch_core.cuh, one CTA of two consumer
// warpgroups and a producer warpgroup per (batch row, block of BM rows of
// N1): A_blk = (W0[blk] . x[b]) (*) tw[blk] on wgmma from a TMA ring, kept
// in shared memory as phase 2's K-major operand, then Z[b][:, blk] = W1 .
// A_blk^T by 128-row chunk pairs, stored from the accumulators. At (16,
// 1024, 1024) the plan is BM 64, a slab of 4 chunk pairs (W0[blk] read
// twice), 5 stages: 256 CTAs in two waves, each reading x[b] and W1 (4
// MiB) and its W0[blk] twice and tw[blk] once (384 KiB), 1.17 GB from L2 a
// call (ops.py::monarch_l2_bytes models it for any plan).
#include "monarch_core.cuh"

using namespace repro;
using namespace repro::monarch;

namespace {

template <int BM, int R>
__global__ void __launch_bounds__(THREADS, 1)
monarch_kernel(const __grid_constant__ Maps mp, bf16* __restrict__ z, int N1,
               int N2, int S) {
  front<false, BM, R>(mp, z, N1, N2, S);
}

template <int BM, int R>
int launch(const Maps& mp, bf16* z, int B, int N1, int N2, int S,
           cudaStream_t s) {
  return launch_smem(monarch_kernel<BM, R>, dim3(N1 / BM, B),
                     smem_bytes(BM, S, N2, false), s, mp, z, N1, N2, S);
}

}  // namespace

// x (B, N1, N2), w0 (N1, N1), tw (N1, N2), w1 (N2, N2) -> z (B, N2, N1),
// all bf16, contiguous; the plan (bm, stages, chunks) is
// ops.py::monarch_plan's for this shape.
extern "C" int monarch_bf16(const void* x, const void* w0, const void* tw,
                            const void* w1, void* z, int B, int N1, int N2,
                            int bm, int stages, int chunks, void* stream) {
  if (B < 1 || !plan_ok(N1, N2, bm, stages, chunks, false))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps mp;
  if (!front_maps(&mp, x, w0, tw, w1, nullptr, nullptr, nullptr, B, N1, N2,
                  bm))
    return static_cast<int>(cudaErrorInvalidValue);
  auto Z = static_cast<bf16*>(z);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool slab = chunks > 1;
  switch (bm) {
    case 64:
      return slab ? launch<64, 4>(mp, Z, B, N1, N2, stages, s)
                  : launch<64, 1>(mp, Z, B, N1, N2, stages, s);
    case 32:
      return slab ? launch<32, 8>(mp, Z, B, N1, N2, stages, s)
                  : launch<32, 1>(mp, Z, B, N1, N2, stages, s);
    default:
      return slab ? launch<16, 8>(mp, Z, B, N1, N2, stages, s)
                  : launch<16, 1>(mp, Z, B, N1, N2, stages, s);
  }
}

// The dynamic shared memory of a launch with this plan, in bytes
extern "C" int monarch_smem_bytes(int bm, int stages, int N2) {
  return smem_bytes(bm, stages, N2, false);
}

// The opt-in dynamic shared memory a block may have on the current device,
// in bytes: what ops.py::monarch_plan fits a plan into
extern "C" int monarch_smem_limit() { return smem_limit(); }

REPRO_EXPORT_ERROR_STRING
