// How fast TMA streams a buffer that stays resident in L2 into the shared
// memory of every SM of one Hopper card: the operand streams of the
// Monarch kernels (src/repro_torch/kernels/monarch_fft/csrc/
// monarch_core.cuh), with no arithmetic.
//
// Each CTA (one per SM) walks an 8 MiB bf16 buffer in tiles of 128 rows x
// 64 columns (16 KB, 128-byte swizzle) through an mbarrier ring, four
// times over. Prints the bytes read from L2 per second over the card: with
// one consumer warp and six stages, then as the kernels stream (two
// consumer warpgroups, five stages). Build and run on the card, from the
// root of the repository:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I src/repro_torch/kernels/csrc -o build/l2_stream_bench \
//        tools/l2_stream_bench.cu && build/l2_stream_bench
#include <cstdio>

#include "hopper.cuh"
#include "tensor_map.cuh"

using namespace repro;

namespace {

constexpr int ROWS = 4096, COLS = 1024;       // 8 MiB of bf16
constexpr int TILE = 128 * 64 * 2, MAX_STAGES = 6, PASSES = 4;
constexpr int TILES = (ROWS / 128) * (COLS / 64);
// more than half an SM's shared memory: one CTA an SM
constexpr int SMEM = 120 * 1024;

// WARPS consumer warps (1, or 8: two warpgroups, as the Monarch kernels
// have) wait on each stage; one warp of each warpgroup (the one warp)
// releases it
template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32 + 32, 1)
stream(const __grid_constant__ CUtensorMap a, int stages, int* sink) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + MAX_STAGES * TILE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int RELEASERS = WARPS == 1 ? 1 : WARPS / 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), RELEASERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // each CTA starts at its own tile, so the card does not stream one tile
  // at a time
  const int first = blockIdx.x * 37;
  if (warp == WARPS) {
    if (lane == 0) {
      for (int i = 0; i < PASSES * TILES; ++i) {
        const int s = i % stages, t = (first + i) % TILES;
        mbar_wait(empty(s), ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full(s), TILE);
        tma_load_2d(base + s * TILE, &a, full(s), (t % (COLS / 64)) * 64,
                    (t / (COLS / 64)) * 128);
      }
    }
  } else {
    int acc = 0;
    for (int i = 0; i < PASSES * TILES; ++i) {
      const int s = i % stages;
      mbar_wait(full(s), (i / stages) & 1);
      acc += static_cast<volatile unsigned char*>(smem_raw)[(base - raw) +
                                                            s * TILE];
      __syncwarp();
      if (warp % 4 == 0 && lane == 0) mbar_arrive(empty(s));
    }
    if (acc == 12345) *sink = acc;
  }
}

}  // namespace

int main() {
  const size_t bytes = (size_t)ROWS * COLS * 2;
  void* buf;
  int* sink;
  cudaMalloc(&buf, bytes);
  cudaMalloc(&sink, 4);
  cudaMemset(buf, 1, bytes);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  CUtensorMap map;
  if (!map_2d_bf16(&map, buf, COLS, ROWS, COLS * 2, 64, 128)) {
    printf("cuTensorMapEncodeTiled failed\n");
    return 1;
  }
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  auto run = [&](auto kern, int warps, int stages) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    // mean of 10 runs after 2 warm-up runs; the buffer stays in L2
    float total = 0.f;
    for (int r = 0; r < 12; ++r) {
      cudaEventRecord(t0);
      kern<<<sms, warps * 32 + 32, SMEM>>>(map, stages, sink);
      cudaEventRecord(t1);
      cudaEventSynchronize(t1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, t0, t1);
      if (r >= 2) total += ms;
    }
    const double ms = total / 10;
    const double bytes = double(sms) * PASSES * TILES * TILE;
    printf("%d consumer warp(s), %d stages: %d CTAs, %.0f B read from L2 in "
           "%.4f ms = %.3f TB/s (%s)\n",
           warps, stages, sms, bytes, ms, bytes / (ms * 1e-3) / 1e12,
           cudaGetErrorString(cudaGetLastError()));
  };
  run(stream<1>, 1, 6);
  // as the Monarch kernels stream: two consumer warpgroups, five stages
  run(stream<8>, 8, 5);
  return 0;
}
