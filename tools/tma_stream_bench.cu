// How fast TMA can stream a row-major bf16 weight into shared memory on one
// Hopper card, for the unit shapes the FFN kernels' weight stream
// (src/repro_torch/kernels/fused_decode/csrc/stream_gemm.cuh) could take:
// no arithmetic, one CTA per SM, each CTA's units a contiguous run of
// column-group-major units, as the kernels assign them; one producer thread
// keeps a 96 KB mbarrier-guarded ring full, one consumer thread releases
// each unit as it lands.
//
//   strips      one 64-column x 64-row box a unit (128 bytes of a row)
//   pairs       two adjacent 64 x 64 boxes a unit, back to back (256 bytes
//               of a row): the kernels' out-projection and down-projection
//   gate/up     two weights, two adjacent 64 x 32 boxes of each a unit
//
// against a device-to-device copy of the same card. Build and run on the
// card, from the root of the repository:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I src/repro_torch/kernels/csrc -o build/tma_stream_bench \
//        tools/tma_stream_bench.cu && build/tma_stream_bench
#include <cstdio>

#include "hopper.cuh"
#include "tensor_map.cuh"

using namespace repro;

namespace {

constexpr int RING = 96 * 1024;
constexpr int K = 8192, N = 11008;     // 180 MB of bf16: gate/up's bytes

enum Mode { STRIPS, PAIRS, GATE_UP };

template <Mode M>
__global__ void __launch_bounds__(64, 1)
stream(const __grid_constant__ CUtensorMap a,
       const __grid_constant__ CUtensorMap b, int units, int* sink) {
  constexpr int BYTES = M == STRIPS ? 8192 : 16384, ST = RING / BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + ST * BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const int lo = (long long)blockIdx.x * units / gridDim.x;
  const int hi = (long long)(blockIdx.x + 1) * units / gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 32) {
    for (int i = 0; i < hi - lo; ++i) {
      const int s = i % ST, u = lo + i;
      mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
      mbar_expect_tx(full(s), BYTES);
      const uint32_t dst = base + s * BYTES;
      if (M == STRIPS) {
        const int kb = K / 64;
        tma_load_2d(dst, &a, full(s), (u / kb) * 64, (u % kb) * 64);
      } else if (M == PAIRS) {
        const int kb = K / 64, n0 = (u / kb) * 128, k0 = (u % kb) * 64;
        tma_load_2d(dst, &a, full(s), n0, k0);
        tma_load_2d(dst + 8192, &a, full(s), n0 + 64, k0);
      } else {
        const int kb = K / 32, n0 = (u / kb) * 128, k0 = (u % kb) * 32;
        tma_load_2d(dst, &a, full(s), n0, k0);
        tma_load_2d(dst + 4096, &a, full(s), n0 + 64, k0);
        tma_load_2d(dst + 8192, &b, full(s), n0, k0);
        tma_load_2d(dst + 12288, &b, full(s), n0 + 64, k0);
      }
    }
  } else if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < hi - lo; ++i) {
      const int s = i % ST;
      mbar_wait(full(s), (i / ST) & 1);
      acc += static_cast<volatile unsigned char*>(smem_raw)[1024 + s * BYTES];
      mbar_arrive(empty(s));
    }
    if (acc == 12345) *sink = acc;
  }
}

}  // namespace

int main() {
  const size_t bytes = (size_t)K * N * 2;
  void *w0, *w1, *flush;
  int* sink;
  cudaMalloc(&w0, bytes);
  cudaMalloc(&w1, bytes);
  cudaMalloc(&flush, 256 << 20);
  cudaMalloc(&sink, 4);
  cudaMemset(w0, 1, bytes);
  cudaMemset(w1, 1, bytes);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  // mean of 10 runs after 2 warm-up runs, the L2 overwritten before each
  auto run = [&](const char* name, auto kern, const CUtensorMap& a,
                 const CUtensorMap& b, int units, double moved) {
    const int smem = RING + 2048;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    float total = 0.f;
    for (int r = 0; r < 12; ++r) {
      cudaMemsetAsync(flush, r, 256 << 20);
      cudaEventRecord(t0);
      kern<<<sms, 64, smem>>>(a, b, units, sink);
      cudaEventRecord(t1);
      cudaEventSynchronize(t1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, t0, t1);
      if (r >= 2) total += ms;
    }
    const float ms = total / 10;
    printf("%-8s %9.0f B in %.4f ms = %.3f TB/s (%s)\n", name, moved, ms,
           moved / (ms * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
  };
  CUtensorMap m64, m32a, m32b;
  if (!map_2d_bf16(&m64, w0, N, K, (uint64_t)N * 2, 64, 64) ||
      !map_2d_bf16(&m32a, w0, N, K, (uint64_t)N * 2, 64, 32) ||
      !map_2d_bf16(&m32b, w1, N, K, (uint64_t)N * 2, 64, 32)) {
    printf("cuTensorMapEncodeTiled failed\n");
    return 1;
  }
  run("strips", stream<STRIPS>, m64, m64, (N / 64) * (K / 64), bytes);
  run("pairs", stream<PAIRS>, m64, m64, (N / 128) * (K / 64), bytes);
  run("gate/up", stream<GATE_UP>, m32a, m32b, (N / 128) * (K / 32),
      2.0 * bytes);
  cudaEventRecord(t0);
  for (int r = 0; r < 10; ++r)
    cudaMemcpyAsync(flush, w0, 128 << 20, cudaMemcpyDeviceToDevice);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, t0, t1);
  printf("copy     %9.0f B read + written in %.4f ms = %.3f TB/s\n",
         2.0 * (128 << 20), ms / 10, 2.0 * (128 << 20) / (ms / 10 * 1e-3) / 1e12);
  return 0;
}
