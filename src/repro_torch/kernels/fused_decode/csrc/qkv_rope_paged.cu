// RMSNorm + per-head Q/K/V projection + per-lane RoPE for the paged decode
// step, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_decode/kernel.py::qkv_rope_paged
// (_qkv_paged_kernel).
//
// Computes, for decode lanes x (B, D): xn = x * rsqrt(mean(x^2) + 1e-6) *
// scale (f32), then per head y = xn @ W[:, head, :] against the native
// wq (D, Hq, dh), wk / wv (D, Hkv, dh) layouts (no concatenated weight), and
// rotates q and k heads by each lane's own position with the host-computed
// inverse frequencies inv_freq (rot/2,) f32. v is not rotated. Outputs
// q (B, Hq, dh), k / v (B, Hkv, dh) in x's type.
//
// Bound: device-memory bytes. The weights are D * (Hq + 2 Hkv) * dh
// elements, read once; at B = 8 the arithmetic is 2 * B flops per weight, far
// below the card's flop-to-byte ratio. Least time = weight bytes / 3.35 TB/s.
//
// Design: RoPE pairs element i with i + rot/2, so a head's dh outputs must
// meet before the rotation; one CTA per head alone gives only 96 CTAs at the
// 7B width. The per-lane factor rsqrt(mean(x^2) + eps) commutes with the
// product, so the weights are split along D instead, in two launches:
//   1. partial[s] = (x * scale)[:, split s] @ W[split s, head, :] for every
//      (head, split) CTA - 384 CTAs at the 7B width, each streaming its slice
//      of the head's weights once through tile_gemm;
//   2. per lane: rstd from x, y = rstd * sum_s partial[s], RoPE, cast.
// The split sums run in a fixed order: results do not change between runs.
#include "tile_gemm.cuh"

using namespace repro;

namespace {

constexpr int NTHREADS = 256;
constexpr int LB = 8;       // lanes per pass over the weights
constexpr int OUT_PER_BLOCK = 1024;
constexpr int KC = 2048;     // rows of A staged per step (dynamic smem)

template <typename T>
struct ScaledX {
  const T* x;
  const T* scale;
  int D;
  __device__ float operator()(int b, int k) const {
    return to_f(x[(size_t)b * D + k]) * to_f(scale[k]);
  }
};

// partial[s, b, hh * DH + e] for head hh = blockIdx.x, split s = blockIdx.y
template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
qkv_partial_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ wq, const T* __restrict__ wk,
                   const T* __restrict__ wv, float* __restrict__ partial,
                   int B, int D, int Hq, int Hkv, int kper) {
  extern __shared__ float a_s[];          // LB * KC floats
  __shared__ float out_s[LB * DH];
  const int hh = blockIdx.x, s = blockIdx.y, Ht = Hq + 2 * Hkv;
  const T* W;
  int H, head;
  if (hh < Hq) {
    W = wq; H = Hq; head = hh;
  } else if (hh < Hq + Hkv) {
    W = wk; H = Hkv; head = hh - Hq;
  } else {
    W = wv; H = Hkv; head = hh - Hq - Hkv;
  }
  const int k0 = s * kper, k1 = min(D, k0 + kper);
  ScaledX<T> a_of{x, scale, D};
  for (int b0 = 0; b0 < B; b0 += LB) {
    // W viewed as (D, H * DH): the head is the column tile [head*DH, +DH)
    tile_gemm<T, DH, 16, LB, 1, NTHREADS, 8, KC>(W, W, H * DH, k0, k1,
                                                 head * DH, b0, B, a_of, a_s,
                                                 out_s);
    for (int i = threadIdx.x; i < LB * DH; i += NTHREADS) {
      const int l = i / DH, e = i % DH;
      if (b0 + l < B)
        partial[((size_t)s * B + b0 + l) * Ht * DH + (size_t)hh * DH + e] =
            out_s[i];
    }
  }
}

// grid (ceil(Ht * DH / OUT_PER_BLOCK), B): lane b's rstd, split sum, RoPE
template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
qkv_rope_out_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                    const int* __restrict__ pos,
                    const float* __restrict__ inv_freq, T* __restrict__ q,
                    T* __restrict__ k, T* __restrict__ v, int B, int D,
                    int Hq, int Hkv, int rot2, int splits) {
  __shared__ float red[32];
  const int b = blockIdx.y, Ht = Hq + 2 * Hkv;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += NTHREADS) {
    const float e = to_f(x[(size_t)b * D + i]);
    ss += e * e;
  }
  const float rstd = rsqrtf(block_sum(ss, red) / (float)D + 1e-6f);
  const size_t stride = (size_t)B * Ht * DH;
  const float* pb = partial + (size_t)b * Ht * DH;
  auto y_at = [&](int i) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += pb[s * stride + i];
    return acc * rstd;
  };
  const int end = min(Ht * DH, (int)(blockIdx.x + 1) * OUT_PER_BLOCK);
  for (int i = blockIdx.x * OUT_PER_BLOCK + threadIdx.x; i < end;
       i += NTHREADS) {
    const int hh = i / DH, e = i % DH;
    const float y = y_at(i);
    float o = y;
    if (hh < Hq + Hkv && e < 2 * rot2) {
      const int j = e < rot2 ? e : e - rot2;
      const float ang = (float)pos[b] * inv_freq[j];
      const float cs = cosf(ang), sn = sinf(ang);
      o = e < rot2 ? y * cs - y_at(i + rot2) * sn
                   : y * cs + y_at(i - rot2) * sn;
    }
    T* dst;
    int H, head;
    if (hh < Hq) {
      dst = q; H = Hq; head = hh;
    } else if (hh < Hq + Hkv) {
      dst = k; H = Hkv; head = hh - Hq;
    } else {
      dst = v; H = Hkv; head = hh - Hq - Hkv;
    }
    dst[((size_t)b * H + head) * DH + e] = from_f<T>(o);
  }
}

template <typename T, int DH>
int launch(const void* x, const void* scale, const void* wq, const void* wk,
           const void* wv, const void* pos, const void* inv_freq, void* q,
           void* k, void* v, void* partial, int B, int D, int Hq, int Hkv,
           int rot2, int splits, cudaStream_t s) {
  const int Ht = Hq + 2 * Hkv;
  const int kper = (D + splits - 1) / splits;
  constexpr int SMEM = a_smem_bytes<LB, KC>();
  cudaFuncSetAttribute(qkv_partial_kernel<T, DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  qkv_partial_kernel<T, DH><<<dim3(Ht, splits), NTHREADS, SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(wq), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<float*>(partial), B, D, Hq, Hkv,
      kper);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblk = (Ht * DH + OUT_PER_BLOCK - 1) / OUT_PER_BLOCK;
  qkv_rope_out_kernel<T, DH><<<dim3(nblk, B), NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<const int*>(pos), static_cast<const float*>(inv_freq),
      static_cast<T*>(q), static_cast<T*>(k), static_cast<T*>(v), B, D, Hq,
      Hkv, rot2, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* wq, const void* wk,
             const void* wv, const void* pos, const void* inv_freq, void* q,
             void* k, void* v, void* partial, int B, int D, int Hq, int Hkv,
             int dh, int rot2, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<T, 32>(x, scale, wq, wk, wv, pos, inv_freq, q, k, v, partial, B, D, Hq, Hkv, rot2, splits, s);
    case 64: return launch<T, 64>(x, scale, wq, wk, wv, pos, inv_freq, q, k, v, partial, B, D, Hq, Hkv, rot2, splits, s);
    case 128: return launch<T, 128>(x, scale, wq, wk, wv, pos, inv_freq, q, k, v, partial, B, D, Hq, Hkv, rot2, splits, s);
    case 256: return launch<T, 256>(x, scale, wq, wk, wv, pos, inv_freq, q, k, v, partial, B, D, Hq, Hkv, rot2, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int qkv_rope_paged_bf16(const void* x, const void* scale,
                                   const void* wq, const void* wk,
                                   const void* wv, const void* pos,
                                   const void* inv_freq, void* q, void* k,
                                   void* v, void* partial, int B, int D,
                                   int Hq, int Hkv, int dh, int rot2,
                                   int splits, void* stream) {
  return dispatch<__nv_bfloat16>(x, scale, wq, wk, wv, pos, inv_freq, q, k, v,
                                 partial, B, D, Hq, Hkv, dh, rot2, splits,
                                 stream);
}

REPRO_EXPORT_ERROR_STRING
