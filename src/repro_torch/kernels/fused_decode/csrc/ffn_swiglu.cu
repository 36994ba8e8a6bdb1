// RMSNorm + SwiGLU FFN of the dense-cache decode step on Hopper (sm_90a):
//
//     out = x + SwiGLU(RMSNorm(x)) @ Wd       (residual = 1)
//     out =     SwiGLU(RMSNorm(x)) @ Wd       (residual = 0: the
//                                              tensor-parallel partial form,
//                                              summed across shards before
//                                              the residual add)
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::ffn_swiglu
// (_ffn_kernel), both forms.
//
// Bound: device-memory bytes, the 3 * D * F weight elements read once
// (270.5 MB, 0.081 ms at the 7B width). Design: oproj_ffn_swiglu.cu's
// gate/up and down weight streams (ffn_passes.cuh), after ffn_prep_kernel
// in place of the out-projection: x's per-tile squares and x * scale as the
// gate/up activation. Three launches, chained by programmatic dependent
// launch.
#include "ffn_passes.cuh"

using namespace repro;

namespace {

// The first pass, in place of oproj_ffn_swiglu's OprojPass: per 64-column
// tile of x (one CTA of 256 threads) each lane's sum of x^2, and x * scale
// as the gate/up activation's hi / lo pair
constexpr int PREP_THREADS = 256;

__global__ void __launch_bounds__(PREP_THREADS)
ffn_prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                float* __restrict__ ss, bf16* __restrict__ img, int B, int D,
                int tiles, int nl) {
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
      store_hi_lo(img, D, nl, b, n, xv * to_f(scale[n]));
    }
    sq = warp_sum(sq);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sq;
    __syncthreads();
    if (col == 0 && b < B)
      ss[(size_t)b * tiles + t] = red[2 * sub] + red[2 * sub + 1];
  }
}

}  // namespace

extern "C" int ffn_swiglu_bf16(const void* x, const void* scale,
                               const void* wg, const void* wu, const void* wd,
                               void* out, void* ws, const long long* plan,
                               int residual, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_lanes(plan[PL_NL], [&](auto L) {
    constexpr int NL = decltype(L)::value;
    const int B = plan[PL_B], D = plan[PL_D];
    const int tiles = (D + SG_NT - 1) / SG_NT;
    FfnStreams<NL> ffn;
    if (!ffn.init(plan, ws, wg, wu, wd))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles);
    cfg.blockDim = dim3(PREP_THREADS);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bf16* xb = static_cast<const bf16*>(x);
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, ffn_prep_kernel, xb, static_cast<const bf16*>(scale),
        at<float>(ws, plan, PL_SS), at<bf16>(ws, plan, PL_IMG_G), B, D, tiles,
        NL);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return ffn.launch(plan, ws, out, nullptr, residual ? xb : nullptr, s);
  });
}

REPRO_EXPORT_ERROR_STRING
