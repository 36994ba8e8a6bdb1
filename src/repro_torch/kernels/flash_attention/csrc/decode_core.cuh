// The CTA body of the port's dense-cache GQA decode kernel on Hopper
// (sm_90a), decode.cu, and the head-shape dispatch (with_head_shape) that
// the paged kernel, decode_paged.cu, shares. Where a lane's token t of kv
// head h lives, the caller hands in as a row functor.
//
// Computes, for one lane b and kv head h, the G grouped queries
// q[b,h,:,:] (scaled by 1/sqrt(dh)) against the lane's first L cached keys
// and values, with an online softmax (m, l, acc) in f32. Positions at or
// past L are never loaded.
//
// Any G >= 1: a CTA serves a query tile of GT = decode_tile(G) of the
// head's G queries, all G at 1/2/4/8 and otherwise one, so a head takes
// G / GT CTAs, each reading the head's K / V (after the first, mostly from
// L2). Tiles of 8 and 16 with dead rows past G, which read K / V fewer
// times, ran slower on an H100 at G 5/6/12/16 (PERF.md, rows 1⁗ and 6′).
//
// Bound: device-memory bytes. Each cached token costs Hkv*dh*2 elements of
// K and V and is read once; at decode batch sizes there is nothing to reuse.
//
// Design: one CTA of 8 warps per (lane, kv head, query tile), which serves
// the tile's queries. The TPU walked the positions along a sequential grid
// axis with the softmax state in VMEM; here the CTA's warps split the
// positions.
// A token's K row is dh elements, EPL per thread, so a warp serves
// 32 / (dh / EPL) tokens at once (4 at dh = 128, bf16); every group of
// threads keeps its own online-softmax state (m, l, acc) in registers and
// loads its next token's K and V before it uses the current ones, so each
// warp has 8 tokens' loads in flight. The states are merged by shuffles
// within the warp, then warp by warp in shared memory, in a fixed order, so
// a launch repeats bit for bit.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int DECODE_NWARPS = 8;

__device__ __forceinline__ void merge_state(float& m, float& l, float pm,
                                            float pl, float& c_self,
                                            float& c_other) {
  const float M = fmaxf(m, pm);
  c_self = (m == -INFINITY) ? 0.f : expf(m - M);
  c_other = (pm == -INFINITY) ? 0.f : expf(pm - M);
  l = l * c_self + pl * c_other;
  m = M;
}

// The CTA of the GT queries at row qrow of q and out (B * Hq, DH), all of
// kv head h: rows(t) is the element offset of token t's row of kv head h
// in kp / vp.
template <typename T, int DH, int GT, int EPL, class Rows>
__device__ __forceinline__ void decode_cta(const T* __restrict__ q,
                                           const T* __restrict__ kp,
                                           const T* __restrict__ vp,
                                           T* __restrict__ out, size_t qrow,
                                           int L, float scale,
                                           const Rows& rows) {
  constexpr int NWARPS = DECODE_NWARPS;
  constexpr int LPT = DH / EPL;       // threads per token
  constexpr int TPW = 32 / LPT;       // tokens per warp step
  static_assert(DH % EPL == 0 && 32 % LPT == 0, "head split");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPT, gl = lane % LPT;

  float qf[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    load_span<T, EPL>(q + (qrow + g) * DH + gl * EPL, qf[g]);
#pragma unroll
    for (int i = 0; i < EPL; ++i) qf[g][i] *= scale;
  }

  auto addr = [&](int t) { return rows(t) + gl * EPL; };

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  constexpr int STEP = NWARPS * TPW;
  // every thread of a warp runs the same iterations (the group reductions
  // shuffle across the warp); a token slot past L contributes nothing
  float kf[EPL] = {}, vf[EPL] = {};
  int t = warp * TPW + grp;
  if (t < L) {
    const size_t a0 = addr(t);
    load_span<T, EPL>(kp + a0, kf);
    load_span<T, EPL>(vp + a0, vf);
  }
  for (int base = warp * TPW; base < L; base += STEP, t += STEP) {
    const bool valid = t < L;
    float kn[EPL] = {}, vn[EPL] = {};
    if (t + STEP < L) {                       // next token's loads first
      const size_t an = addr(t + STEP);
      load_span<T, EPL>(kp + an, kn);
      load_span<T, EPL>(vp + an, vn);
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) s += qf[g][i] * kf[i];
#pragma unroll
      for (int o = LPT / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (valid) {
        const float mn = fmaxf(m[g], s);
        const float alpha = expf(m[g] - mn);
        const float p = expf(s - mn);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[i];
        m[g] = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      kf[i] = kn[i];
      vf[i] = vn[i];
    }
  }

  // merge the token groups of the warp
#pragma unroll
  for (int o = LPT; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float pm = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float pl = __shfl_xor_sync(0xffffffffu, l[g], o);
      float cs, co;
      merge_state(m[g], l[g], pm, pl, cs, co);
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const float pa = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * cs + pa * co;
      }
    }
  }

  // merge the warps in a fixed order
  __shared__ float sm_m[NWARPS][GT];
  __shared__ float sm_l[GT];
  __shared__ float sm_acc[GT][DH];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) sm_m[warp][g] = m[g];
  }
  for (int i = threadIdx.x; i < GT * DH; i += blockDim.x) (&sm_acc[0][0])[i] = 0.f;
  if (threadIdx.x < GT) sm_l[threadIdx.x] = 0.f;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float M = -INFINITY;
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    const float c = (m[g] == -INFINITY) ? 0.f : expf(m[g] - M);
    l[g] *= c;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] *= c;
  }
  for (int w = 0; w < NWARPS; ++w) {
    if (warp == w && lane < LPT) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) sm_acc[g][gl * EPL + i] += acc[g][i];
        if (lane == 0) sm_l[g] += l[g];
      }
    }
    __syncthreads();
  }
  T* o = out + qrow * DH;
  for (int i = threadIdx.x; i < GT * DH; i += blockDim.x) {
    const int g = i / DH;
    o[i] = from_f<T>((&sm_acc[0][0])[i] / fmaxf(sm_l[g], 1e-30f));
  }
}

// Elements each thread holds of a K / V row: fewer with more queries per
// tile, so the per-query accumulators stay in registers.
template <int GT>
constexpr int decode_epl() { return GT <= 2 ? 16 : 8; }

// The query tile of a kv head's group of G: G itself at 1/2/4/8, else 1.
constexpr int decode_tile(int G) {
  return G == 1 || G == 2 || G == 4 || G == 8 ? G : 1;
}

// The CTAs of one kv head, G / GT: G at GT 1, else 1 (a compile-time 1,
// so that a kernel with GT > 1 divides by nothing).
template <int GT>
__host__ __device__ __forceinline__ int decode_tiles(int G) {
  return GT == 1 ? G : 1;
}

// Calls f(DH, GT) with both as std::integral_constant for the head widths
// the kernels are built for and GT = decode_tile(G); other head widths, and
// G < 1, are refused.
template <class F>
int with_head_shape(int dh, int G, F&& f) {
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto by_group = [&](auto dh_c) {
    switch (decode_tile(G)) {
      case 1: return f(dh_c, std::integral_constant<int, 1>{});
      case 2: return f(dh_c, std::integral_constant<int, 2>{});
      case 4: return f(dh_c, std::integral_constant<int, 4>{});
      case 8: return f(dh_c, std::integral_constant<int, 8>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (dh) {
    case 32: return by_group(std::integral_constant<int, 32>{});
    case 64: return by_group(std::integral_constant<int, 64>{});
    case 128: return by_group(std::integral_constant<int, 128>{});
    case 256: return by_group(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro
