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
// Design: the TPU kernel keeps y in VMEM across one sequential grid over F.
// On Hopper the weights must be spread over all SMs, and RMSNorm(y) needs the
// whole of y first, so the epilogue is five launches on one stream, each a
// pass the card runs in parallel, with f32 scratch from the wrapper:
//   1. partial_o[s] = attn @ Wo[rows of split s]   (column tiles x K splits)
//   2. y = x + sum_s partial_o[s], and per 256-column chunk sum(y^2)
//   3. h = silu(g) * u with g, u = (y * rstd * scale) @ Wg, Wu  (F tiles;
//      each CTA first sums the chunks' squares into its lanes' rstd)
//   4. partial_d[s] = h @ Wd[rows of split s]       (column tiles x F splits)
//   5. out = y + sum_s partial_d[s], cast to x's type
// Every sum runs in a fixed order: the result does not change between runs.
// Splitting the down-projection by F-chunk inside pass 3 would write B x D
// f32 partials per chunk (22 MB per layer at 172 chunks); the separate pass 4
// writes 4 x B x D.
#include "tile_gemm.cuh"

using namespace repro;

namespace {

constexpr int NTHREADS = 256;
constexpr int LB = 8;
constexpr int NT = 64;       // column tile of the split-K products
constexpr int KC = 2048;     // rows of A staged per step (dynamic smem)
constexpr int CHUNK = 256;   // columns per block of the residual pass

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
  const float* rstd;  // shared, LB entries for lanes b0..b0+LB-1
  const T* scale;
  int D, b0;
  __device__ float operator()(int b, int k) const {
    return y[(size_t)b * D + k] * rstd[b - b0] * to_f(scale[k]);
  }
};

// partial[s, b, n] = sum over split s of K of a[b, k] * W[k, n]
template <typename T, typename A>
__global__ void __launch_bounds__(NTHREADS)
splitk_gemm_kernel(const A* __restrict__ a, const T* __restrict__ W,
                   float* __restrict__ partial, int B, int K, int N,
                   int kper) {
  extern __shared__ float a_s[];          // LB * KC floats
  __shared__ float out_s[LB * NT];
  const int n0 = blockIdx.x * NT, s = blockIdx.y;
  const int k0 = s * kper, k1 = min(K, k0 + kper);
  Rows<A> a_of{a, K};
  for (int b0 = 0; b0 < B; b0 += LB) {
    tile_gemm<T, NT, 16, LB, 1, NTHREADS, 8, KC>(W, W, N, k0, k1, n0, b0, B,
                                                 a_of, a_s, out_s);
    for (int i = threadIdx.x; i < LB * NT; i += NTHREADS) {
      const int l = i / NT, n = n0 + i % NT;
      if (b0 + l < B && n < N)
        partial[((size_t)s * B + b0 + l) * N + n] = out_s[i];
    }
  }
}

// y = x + sum_s partial[s]; ss[b, chunk] = sum of y^2 over the chunk;
// grid (ceil(D / CHUNK), B), CHUNK threads
template <typename T>
__global__ void __launch_bounds__(CHUNK)
residual_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                float* __restrict__ y, float* __restrict__ ss, int B, int D,
                int splits) {
  __shared__ float red[32];
  const int b = blockIdx.y, n = blockIdx.x * CHUNK + threadIdx.x;
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
__global__ void __launch_bounds__(NTHREADS)
gate_up_kernel(const float* __restrict__ y, const float* __restrict__ ss,
               const T* __restrict__ scale, const T* __restrict__ wg,
               const T* __restrict__ wu, float* __restrict__ h, int B, int D,
               int F, int n_chunks) {
  extern __shared__ float a_s[];          // LB * KC floats
  __shared__ float out_s[2 * LB * NT];
  __shared__ float rstd[LB];
  const int n0 = blockIdx.x * NT;
  for (int b0 = 0; b0 < B; b0 += LB) {
    if (threadIdx.x < LB && b0 + threadIdx.x < B) {
      float t = 0.f;
      for (int c = 0; c < n_chunks; ++c)
        t += ss[(size_t)(b0 + threadIdx.x) * n_chunks + c];
      rstd[threadIdx.x] = rsqrtf(t / (float)D + 1e-6f);
    }
    NormedY<T> a_of{y, rstd, scale, D, b0};
    tile_gemm<T, NT, 8, LB, 2, NTHREADS, 8, KC>(wg, wu, F, 0, D, n0, b0, B,
                                                a_of, a_s, out_s);
    for (int i = threadIdx.x; i < LB * NT; i += NTHREADS) {
      const int l = i / NT, n = n0 + i % NT;
      if (b0 + l < B && n < F) {
        const float g = out_s[i], u = out_s[LB * NT + i];
        h[(size_t)(b0 + l) * F + n] = g * (1.f / (1.f + expf(-g))) * u;
      }
    }
  }
}

// out = y + sum_s partial[s], cast to T
template <typename T>
__global__ void residual_out_kernel(const float* __restrict__ y,
                                    const float* __restrict__ partial,
                                    T* __restrict__ out, int BD, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BD) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * BD + i];
  out[i] = from_f<T>(y[i] + acc);
}

#define REPRO_CHECK_LAUNCH()                        \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <typename T>
int run(const void* x, const void* attn, const void* wo, const void* scale,
        const void* wg, const void* wu, const void* wd, void* out, void* y,
        void* ss, void* h, void* p_o, void* p_d, int B, int D, int HD, int F,
        int splits_o, int splits_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int SMEM = a_smem_bytes<LB, KC>();
  cudaFuncSetAttribute(splitk_gemm_kernel<T, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(splitk_gemm_kernel<T, float>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(gate_up_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  REPRO_CHECK_LAUNCH();
  const T* xt = static_cast<const T*>(x);
  float* yf = static_cast<float*>(y);
  float* ssf = static_cast<float*>(ss);
  float* hf = static_cast<float*>(h);
  float* po = static_cast<float*>(p_o);
  float* pd = static_cast<float*>(p_d);
  const int tiles_d = (D + NT - 1) / NT, tiles_f = (F + NT - 1) / NT;
  const int n_chunks = (D + CHUNK - 1) / CHUNK;
  const int kper_o = (HD + splits_o - 1) / splits_o;
  const int kper_d = (F + splits_d - 1) / splits_d;

  splitk_gemm_kernel<T, T><<<dim3(tiles_d, splits_o), NTHREADS, SMEM, s>>>(
      static_cast<const T*>(attn), static_cast<const T*>(wo), po, B, HD, D,
      kper_o);
  REPRO_CHECK_LAUNCH();
  residual_kernel<T><<<dim3(n_chunks, B), CHUNK, 0, s>>>(xt, po, yf, ssf, B,
                                                          D, splits_o);
  REPRO_CHECK_LAUNCH();
  gate_up_kernel<T><<<tiles_f, NTHREADS, SMEM, s>>>(
      yf, ssf, static_cast<const T*>(scale), static_cast<const T*>(wg),
      static_cast<const T*>(wu), hf, B, D, F, n_chunks);
  REPRO_CHECK_LAUNCH();
  splitk_gemm_kernel<T, float><<<dim3(tiles_d, splits_d), NTHREADS, SMEM, s>>>(
      hf, static_cast<const T*>(wd), pd, B, F, D, kper_d);
  REPRO_CHECK_LAUNCH();
  residual_out_kernel<T><<<(B * D + NTHREADS - 1) / NTHREADS, NTHREADS, 0, s>>>(
      yf, pd, static_cast<T*>(out), B * D, splits_d);
  REPRO_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" int oproj_ffn_swiglu_bf16(const void* x, const void* attn,
                                     const void* wo, const void* scale,
                                     const void* wg, const void* wu,
                                     const void* wd, void* out, void* y,
                                     void* ss, void* h, void* p_o,
                                     void* p_d, int B, int D, int HD, int F,
                                     int splits_o, int splits_d,
                                     void* stream) {
  return run<__nv_bfloat16>(x, attn, wo, scale, wg, wu, wd, out, y, ss, h,
                            p_o, p_d, B, D, HD, F, splits_o, splits_d, stream);
}

REPRO_EXPORT_ERROR_STRING
