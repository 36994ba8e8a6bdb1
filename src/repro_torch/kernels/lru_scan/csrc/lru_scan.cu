// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lru_scan/kernel.py::lru_scan (_lru_kernel),
// reached through lru_scan/ops.py::lru_scan; recurrentgemma's prefill
// (models/rglru.py::rec_block).
//
// Computes h (B, S, D) from a, b (B, S, D), all f32 and contiguous.
//
// Bound: device-memory bytes: a and b read once, h written once, 3 * B * S
// * D * 4 bytes (589.8 MB at B 4, S 3000, D 4096: 0.176 ms at 3.35 TB/s);
// two flops per element.
//
// Design: the TPU kernel carried h in VMEM scratch across a sequential grid
// axis over time. On Hopper blocks run in parallel and carry nothing, so
// each thread owns one (b, d) channel and walks all of S itself, h in a
// register. Neighbouring threads take neighbouring d, so each timestep's
// loads and stores are coalesced. The walk goes in chunks of U timesteps:
// the next chunk's 2 * U loads are issued before the current chunk's fmas,
// so they are in flight while it runs. Only B * D threads exist (16384 at
// RecurrentGemma's widths, under one 128-thread block per SM), so the
// kernel is bound by load latency, not bandwidth; a chunked two-pass scan
// that fills the card is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int U = 16;             // timesteps per chunk

__global__ void __launch_bounds__(THREADS)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ h, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.y * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;

  float ca[U], cb[U], na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool ok = u < S;
    ca[u] = ok ? __ldg(ap + (size_t)u * D) : 0.f;
    cb[u] = ok ? __ldg(bp + (size_t)u * D) : 0.f;
  }
  float hs = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {           // the next chunk's loads first
      const int t = t0 + U + u;
      const bool ok = t < S;
      na[u] = ok ? __ldg(ap + (size_t)t * D) : 0.f;
      nb[u] = ok ? __ldg(bp + (size_t)t * D) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        hs = fmaf(ca[u], hs, cb[u]);
        hp[(size_t)t * D] = hs;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                    const float* __restrict__ dh, float* __restrict__ da,
                    float* __restrict__ db, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.y * S * D + d;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = dh + base;
  float* dap = da + base;
  float* dbp = db + base;

  // timestep t's a_t, h_{t-1} and dh_t (zeros outside [0, S))
  auto load = [&](int t, float& av, float& hv, float& gv) {
    const bool ok = t >= 0;
    av = ok ? __ldg(ap + (size_t)t * D) : 0.f;
    gv = ok ? __ldg(gp + (size_t)t * D) : 0.f;
    hv = t >= 1 ? __ldg(hp + (size_t)(t - 1) * D) : 0.f;
  };
  float ca[U], ch[U], cg[U], na[U], nh[U], ng[U];
#pragma unroll
  for (int u = 0; u < U; ++u) load(S - 1 - u, ca[u], ch[u], cg[u]);
  float g = 0.f, a_next = 0.f;       // g_{t+1} and a_{t+1}
  for (int t1 = S - 1; t1 >= 0; t1 -= U) {
#pragma unroll
    for (int u = 0; u < U; ++u)             // the next chunk's loads first
      load(t1 - U - u, na[u], nh[u], ng[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        g = fmaf(a_next, g, cg[u]);
        dbp[(size_t)t * D] = g;
        dap[(size_t)t * D] = g * ch[u];
        a_next = ca[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      ch[u] = nh[u];
      cg[u] = ng[u];
    }
  }
}

}  // namespace

extern "C" int lru_scan_bwd_f32(const void* a, const void* h, const void* dh,
                                void* da, void* db, int B, int S, int D,
                                void* stream) {
  if (B < 1 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  lru_scan_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<float*>(da),
      static_cast<float*>(db), S, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lru_scan_f32(const void* a, const void* b, void* h, int B,
                            int S, int D, void* stream) {
  if (B < 1 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  lru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, D);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
