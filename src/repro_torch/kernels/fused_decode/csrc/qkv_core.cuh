// The two passes shared by the port's RMSNorm + QKV + RoPE kernels on
// Hopper (sm_90a): qkv_rope_paged.cu (native wq / wk / wv, a position per
// lane) and qkv_rope.cu (one concatenated w_qkv, a position shared by the
// batch, partial rotation). What differs - where a head's weights sit,
// each lane's position, where an output goes - is handed in as functors.
//
// Computes, for decode lanes x (B, D): xn = x * rsqrt(mean(x^2) + 1e-6) *
// scale (f32), per head y = xn @ W_head, and rotates the q and k heads: the
// first 2 * rot2 elements of a head by the lane's position with the
// host-computed inverse frequencies inv_freq (rot2,) f32; the rest of the
// head, and every v head, pass through unrotated.
//
// Bound: device-memory bytes. The weights are D * (Hq + 2 Hkv) * dh
// elements, read once; at B = 8 the arithmetic is 2 * B flops per weight,
// far below the card's flop-to-byte ratio. Least time = weight bytes /
// 3.35 TB/s.
//
// Design: RoPE pairs element i with i + rot2, so a head's dh outputs must
// meet before the rotation; one CTA per head alone gives only 96 CTAs at
// the 7B width. The per-lane factor rsqrt(mean(x^2) + eps) commutes with
// the product, so the weights are split along D instead, in two launches:
//   1. partial[s] = (x * scale)[:, split s] @ W[split s, head] for every
//      (head, split) CTA - 384 CTAs at the 7B width, each streaming its
//      slice of the head's weights once through tile_gemm;
//   2. per lane: rstd from x, y = rstd * sum_s partial[s], RoPE, cast.
// The split sums run in a fixed order: results do not change between runs.
#pragma once

#include <type_traits>

#include "tile_gemm.cuh"

namespace repro {

constexpr int QKV_NTHREADS = 256;
constexpr int QKV_LB = 8;             // lanes per pass over the weights
constexpr int QKV_OUT_PER_BLOCK = 1024;
constexpr int QKV_KC = 2048;          // rows of A staged per step (dynamic smem)

// Head hh's weights: the column tile [col0, col0 + DH) of a row-major
// (D, ncols) matrix W.
template <typename T>
struct HeadTile {
  const T* W;
  int ncols;
  int col0;
};

template <typename T>
struct ScaledX {
  const T* x;
  const T* scale;
  int D;
  __device__ float operator()(int b, int k) const {
    return to_f(x[(size_t)b * D + k]) * to_f(scale[k]);
  }
};

// partial[s, b, hh * DH + e] for head hh = blockIdx.x, split s = blockIdx.y;
// head_of(hh) -> HeadTile<T>
template <typename T, int DH, class HeadOf>
__global__ void __launch_bounds__(QKV_NTHREADS)
qkv_partial_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   HeadOf head_of, float* __restrict__ partial, int B, int D,
                   int Ht, int kper) {
  extern __shared__ float a_s[];          // QKV_LB * QKV_KC floats
  __shared__ float out_s[QKV_LB * DH];
  const int hh = blockIdx.x, s = blockIdx.y;
  const HeadTile<T> w = head_of(hh);
  const int k0 = s * kper, k1 = min(D, k0 + kper);
  ScaledX<T> a_of{x, scale, D};
  for (int b0 = 0; b0 < B; b0 += QKV_LB) {
    tile_gemm<T, DH, 16, QKV_LB, 1, QKV_NTHREADS, 8, QKV_KC>(
        w.W, w.W, w.ncols, k0, k1, w.col0, b0, B, a_of, a_s, out_s);
    for (int i = threadIdx.x; i < QKV_LB * DH; i += QKV_NTHREADS) {
      const int l = i / DH, e = i % DH;
      if (b0 + l < B)
        partial[((size_t)s * B + b0 + l) * Ht * DH + (size_t)hh * DH + e] =
            out_s[i];
    }
  }
}

// grid (ceil(Ht * DH / QKV_OUT_PER_BLOCK), B): lane b's rstd, split sum,
// RoPE of the first Hrot heads (q and k), cast; out(hh, b, e) -> T& is where
// the value goes, out.pos(b) the lane's position
template <typename T, int DH, class Out>
__global__ void __launch_bounds__(QKV_NTHREADS)
qkv_rope_out_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                    const float* __restrict__ inv_freq, Out out, int B, int D,
                    int Ht, int Hrot, int rot2, int splits) {
  __shared__ float red[32];
  const int b = blockIdx.y;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += QKV_NTHREADS) {
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
  const int end = min(Ht * DH, (int)(blockIdx.x + 1) * QKV_OUT_PER_BLOCK);
  for (int i = blockIdx.x * QKV_OUT_PER_BLOCK + threadIdx.x; i < end;
       i += QKV_NTHREADS) {
    const int hh = i / DH, e = i % DH;
    const float y = y_at(i);
    float o = y;
    if (hh < Hrot && e < 2 * rot2) {
      const int j = e < rot2 ? e : e - rot2;
      const float ang = (float)out.pos(b) * inv_freq[j];
      const float cs = cosf(ang), sn = sinf(ang);
      o = e < rot2 ? y * cs - y_at(i + rot2) * sn
                   : y * cs + y_at(i - rot2) * sn;
    }
    out(hh, b, e) = from_f<T>(o);
  }
}

// Both passes on one stream; returns the first launch error.
template <typename T, int DH, class HeadOf, class Out>
int qkv_rope_launch(const T* x, const T* scale, HeadOf head_of,
                    const float* inv_freq, Out out, float* partial, int B,
                    int D, int Ht, int Hrot, int rot2, int splits,
                    cudaStream_t s) {
  const int kper = (D + splits - 1) / splits;
  constexpr int SMEM = a_smem_bytes<QKV_LB, QKV_KC>();
  cudaFuncSetAttribute(qkv_partial_kernel<T, DH, HeadOf>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  qkv_partial_kernel<T, DH, HeadOf>
      <<<dim3(Ht, splits), QKV_NTHREADS, SMEM, s>>>(x, scale, head_of,
                                                     partial, B, D, Ht, kper);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblk = (Ht * DH + QKV_OUT_PER_BLOCK - 1) / QKV_OUT_PER_BLOCK;
  qkv_rope_out_kernel<T, DH, Out><<<dim3(nblk, B), QKV_NTHREADS, 0, s>>>(
      x, partial, inv_freq, out, B, D, Ht, Hrot, rot2, splits);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(DH) with DH as a std::integral_constant for the head widths the
// kernels are built for; other widths are refused.
template <class F>
int with_head_dim(int dh, F&& f) {
  switch (dh) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro
