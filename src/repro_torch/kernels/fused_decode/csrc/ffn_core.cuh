// The passes shared by the port's FFN kernels on Hopper (sm_90a):
// oproj_ffn_swiglu.cu (out-projection + residual + FFN + residual, the paged
// layer epilogue) and ffn_swiglu.cu (RMSNorm + SwiGLU FFN, with or without
// the residual).
//
// Bound: device-memory bytes. The FFN weights are 3 * D * F elements
// (270.5 MB in bf16 at the 7B width), read once; at B = 8 the arithmetic is
// 2 * B flops per weight. Least time = weight bytes / 3.35 TB/s.
//
// Design: the TPU kernels keep the activation in VMEM across one
// sequential grid over F. On Hopper the weights must be spread over all
// SMs, and RMSNorm(y) needs the whole of y first, so each kernel is a few
// launches on one stream, each a pass the card runs in parallel, with f32
// scratch from the wrapper:
//   splitk_gemm_kernel  partial[s] = a @ W[rows of split s]
//                       (column tiles x K splits)
//   residual_kernel     y = x + sum_s partial[s], and per 256-column chunk
//                       sum(y^2)
//   gate_up_kernel      h = silu(g) * u with g, u = (y * rstd * scale) @
//                       Wg, Wu (F tiles; each CTA first sums the chunks'
//                       squares into its lanes' rstd)
//   residual_out_kernel out = [y +] sum_s partial[s], cast to x's type
// Every sum runs in a fixed order: the result does not change between runs.
// Splitting the down-projection by F-chunk inside gate_up_kernel would write
// B x D f32 partials per chunk (22 MB per layer at 172 chunks); the
// separate split-K pass writes splits x B x D.
#pragma once

#include "tile_gemm.cuh"

namespace repro {

constexpr int FFN_NTHREADS = 256;
constexpr int FFN_LB = 8;
constexpr int FFN_NT = 64;       // column tile of the split-K products
constexpr int FFN_KC = 2048;     // rows of A staged per step (dynamic smem)
constexpr int FFN_CHUNK = 256;   // columns per block of the residual pass

template <typename A>
struct Rows {  // plain row-major (B, K) operand
  const A* a;
  int K;
  __device__ float operator()(int b, int k) const {
    return to_f(a[(size_t)b * K + k]);
  }
};

template <typename T>
struct NormedY {
  const float* y;
  const float* rstd;  // shared, FFN_LB entries for lanes b0..b0+FFN_LB-1
  const T* scale;
  int D, b0;
  __device__ float operator()(int b, int k) const {
    return y[(size_t)b * D + k] * rstd[b - b0] * to_f(scale[k]);
  }
};

// partial[s, b, n] = sum over split s of K of a[b, k] * W[k, n]
template <typename T, typename A>
__global__ void __launch_bounds__(FFN_NTHREADS)
splitk_gemm_kernel(const A* __restrict__ a, const T* __restrict__ W,
                   float* __restrict__ partial, int B, int K, int N,
                   int kper) {
  extern __shared__ float a_s[];          // FFN_LB * FFN_KC floats
  __shared__ float out_s[FFN_LB * FFN_NT];
  const int n0 = blockIdx.x * FFN_NT, s = blockIdx.y;
  const int k0 = s * kper, k1 = min(K, k0 + kper);
  Rows<A> a_of{a, K};
  for (int b0 = 0; b0 < B; b0 += FFN_LB) {
    tile_gemm<T, FFN_NT, 16, FFN_LB, 1, FFN_NTHREADS, 8, FFN_KC>(
        W, W, N, k0, k1, n0, b0, B, a_of, a_s, out_s);
    for (int i = threadIdx.x; i < FFN_LB * FFN_NT; i += FFN_NTHREADS) {
      const int l = i / FFN_NT, n = n0 + i % FFN_NT;
      if (b0 + l < B && n < N)
        partial[((size_t)s * B + b0 + l) * N + n] = out_s[i];
    }
  }
}

// y = x + sum_s partial[s] (y = x when splits is 0); ss[b, chunk] = sum of
// y^2 over the chunk; grid (ceil(D / FFN_CHUNK), B), FFN_CHUNK threads
template <typename T>
__global__ void __launch_bounds__(FFN_CHUNK)
residual_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                float* __restrict__ y, float* __restrict__ ss, int B, int D,
                int splits) {
  __shared__ float red[32];
  const int b = blockIdx.y, n = blockIdx.x * FFN_CHUNK + threadIdx.x;
  float v = 0.f;
  if (n < D) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[((size_t)s * B + b) * D + n];
    v = to_f(x[(size_t)b * D + n]) + acc;
    y[(size_t)b * D + n] = v;
  }
  const float t = block_sum(v * v, red);
  if (threadIdx.x == 0) ss[(size_t)b * gridDim.x + blockIdx.x] = t;
}

// h[b, f] = silu(g) * u, g / u = (y * rstd * scale) @ Wg / Wu; grid F / NT
template <typename T>
__global__ void __launch_bounds__(FFN_NTHREADS)
gate_up_kernel(const float* __restrict__ y, const float* __restrict__ ss,
               const T* __restrict__ scale, const T* __restrict__ wg,
               const T* __restrict__ wu, float* __restrict__ h, int B, int D,
               int F, int n_chunks) {
  extern __shared__ float a_s[];          // FFN_LB * FFN_KC floats
  __shared__ float out_s[2 * FFN_LB * FFN_NT];
  __shared__ float rstd[FFN_LB];
  const int n0 = blockIdx.x * FFN_NT;
  for (int b0 = 0; b0 < B; b0 += FFN_LB) {
    if (threadIdx.x < FFN_LB && b0 + threadIdx.x < B) {
      float t = 0.f;
      for (int c = 0; c < n_chunks; ++c)
        t += ss[(size_t)(b0 + threadIdx.x) * n_chunks + c];
      rstd[threadIdx.x] = rsqrtf(t / (float)D + 1e-6f);
    }
    NormedY<T> a_of{y, rstd, scale, D, b0};
    tile_gemm<T, FFN_NT, 8, FFN_LB, 2, FFN_NTHREADS, 8, FFN_KC>(
        wg, wu, F, 0, D, n0, b0, B, a_of, a_s, out_s);
    for (int i = threadIdx.x; i < FFN_LB * FFN_NT; i += FFN_NTHREADS) {
      const int l = i / FFN_NT, n = n0 + i % FFN_NT;
      if (b0 + l < B && n < F) {
        const float g = out_s[i], u = out_s[FFN_LB * FFN_NT + i];
        h[(size_t)(b0 + l) * F + n] = g * (1.f / (1.f + expf(-g))) * u;
      }
    }
  }
}

// out = y + sum_s partial[s] (with_y) or sum_s partial[s], cast to T
template <typename T>
__global__ void residual_out_kernel(const float* __restrict__ y,
                                    const float* __restrict__ partial,
                                    T* __restrict__ out, int BD, int splits,
                                    int with_y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BD) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * BD + i];
  out[i] = from_f<T>(with_y ? y[i] + acc : acc);
}

#define REPRO_CHECK_LAUNCH()                        \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// The FFN half of both kernels, from the f32 activation y (B, D) and its
// per-chunk squares ss:
//   h = silu(RMSNorm(y) @ Wg) * (RMSNorm(y) @ Wu);  out = [y +] h @ Wd
template <typename T>
int ffn_passes(const float* y, const float* ss, const T* scale, const T* wg,
               const T* wu, const T* wd, T* out, float* h, float* p_d, int B,
               int D, int F, int splits_d, int with_y, cudaStream_t s) {
  constexpr int SMEM = a_smem_bytes<FFN_LB, FFN_KC>();
  cudaFuncSetAttribute(splitk_gemm_kernel<T, float>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(gate_up_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  REPRO_CHECK_LAUNCH();
  const int tiles_d = (D + FFN_NT - 1) / FFN_NT;
  const int tiles_f = (F + FFN_NT - 1) / FFN_NT;
  const int n_chunks = (D + FFN_CHUNK - 1) / FFN_CHUNK;
  const int kper_d = (F + splits_d - 1) / splits_d;
  gate_up_kernel<T><<<tiles_f, FFN_NTHREADS, SMEM, s>>>(y, ss, scale, wg, wu,
                                                        h, B, D, F, n_chunks);
  REPRO_CHECK_LAUNCH();
  splitk_gemm_kernel<T, float>
      <<<dim3(tiles_d, splits_d), FFN_NTHREADS, SMEM, s>>>(h, wd, p_d, B, F,
                                                           D, kper_d);
  REPRO_CHECK_LAUNCH();
  residual_out_kernel<T>
      <<<(B * D + FFN_NTHREADS - 1) / FFN_NTHREADS, FFN_NTHREADS, 0, s>>>(
          y, p_d, out, B * D, splits_d, with_y);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace repro
