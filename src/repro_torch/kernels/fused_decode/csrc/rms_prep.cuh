// RMSNorm's first pass for the weight streams that take a bf16 decode
// input x (B, D) (ffn_swiglu.cu, qkv_rope_paged.cu, qkv_rope.cu), and the
// per-lane rstd their epilogues apply to the finished sums:
//
//     RMSNorm(x) @ W = rstd * ((x * scale) @ W),
//     rstd = rsqrt(mean(x^2) + 1e-6) per lane
//
// rms_prep_kernel writes, per 64-column tile of x and lane, the sum of x^2,
// and x * scale as the stream's hi / lo bf16 activation; lanes_rstd sums a
// lane's tiles in a fixed order. The prep kernel waits for the kernel ahead
// of it on the stream (griddep_wait) before it reads x, and lets the next
// one start at once: the weight stream after it loads its first weights
// meanwhile.
#pragma once

#include "stream_gemm.cuh"

namespace repro {

constexpr int PREP_THREADS = 256;

// per 64-column tile of x (one CTA of 256 threads) each lane's sum of x^2
// into ss (B, tiles), and x * scale as the hi / lo pair into img (2 NL, D)
template <int NL>
__global__ void __launch_bounds__(PREP_THREADS)
rms_prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                float* __restrict__ ss, bf16* __restrict__ img, int B, int D,
                int tiles) {
  __shared__ float red[PREP_THREADS / 32];
  griddep_launch_dependents();
  griddep_wait();
  const int t = blockIdx.x, col = threadIdx.x % SG_NT;
  const int sub = threadIdx.x / SG_NT, n = t * SG_NT + col;
  constexpr int PER = PREP_THREADS / SG_NT;        // lanes per round
  for (int b0 = 0; b0 < B; b0 += PER) {
    const int b = b0 + sub;
    float sq = 0.f;
    if (b < B && n < D) {
      const float xv = to_f(x[(size_t)b * D + n]);
      sq = xv * xv;
      store_hi_lo(img, D, NL, b, n, xv * to_f(scale[n]));
    }
    sq = warp_sum(sq);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sq;
    __syncthreads();
    if (col == 0 && b < B)
      ss[(size_t)b * tiles + t] = red[2 * sub] + red[2 * sub + 1];
  }
}

// Launches rms_prep_kernel with programmatic stream serialisation.
template <int NL>
int launch_rms_prep(const bf16* x, const bf16* scale, float* ss, bf16* img,
                    int B, int D, cudaStream_t s) {
  const int tiles = (D + SG_NT - 1) / SG_NT;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles);
  cfg.blockDim = dim3(PREP_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, rms_prep_kernel<NL>, x, scale, ss,
                                     img, B, D, tiles);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// rstd[b] for lanes b < NL (0 past B) from the per-tile squares ss (B,
// tiles): warp w takes lanes w, w + 4, ...; its threads load the tiles 32
// apart, all in flight at once, then sum in a fixed order. The stream's
// consumer threads call it, and meet at a named barrier after it.
template <int NL>
__device__ __forceinline__ void lanes_rstd(const float* ss, int B, int D,
                                           int tiles, float* rstd) {
  constexpr int PER = 8;                       // loads per thread and lane
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
  for (int b = w; b < NL; b += SG_CONSUMERS / 32) {
    float s = 0.f;
    for (int k0 = 0; k0 < tiles; k0 += 32 * PER) {
      float part[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int kt = k0 + 32 * k + l;
        part[k] = b < B && kt < tiles ? __ldcg(ss + (size_t)b * tiles + kt)
                                      : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) s += part[k];
    }
    s = warp_sum(s);
    if (l == 0) rstd[b] = b < B ? rsqrtf(s / (float)D + 1e-6f) : 0.f;
  }
  named_sync(1, SG_CONSUMERS);
}

}  // namespace repro
