// What the port's paged GQA decode kernel on Hopper (sm_90a),
// decode_paged.cu, takes from the decode kernels' first design: the merge
// of two online-softmax states (merge_state), the query tile a CTA serves
// (decode_tile, decode_tiles) and the head-shape dispatch
// (with_head_shape).
//
// Any G >= 1: a CTA serves a query tile of GT = decode_tile(G) of the
// head's G queries, all G at 1/2/4/8 and otherwise one, so a head takes
// G / GT CTAs, each reading the head's K / V (after the first, mostly from
// L2). Tiles of 8 and 16 with dead rows past G, which read K / V fewer
// times, ran slower on an H100 at G 5/6/12/16 (PERF.md, row 1⁗). The
// dense-cache kernel, decode.cu, serves the whole group on tensor cores
// instead and shares nothing here.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

__device__ __forceinline__ void merge_state(float& m, float& l, float pm,
                                            float pl, float& c_self,
                                            float& c_other) {
  const float M = fmaxf(m, pm);
  c_self = (m == -INFINITY) ? 0.f : expf(m - M);
  c_other = (pm == -INFINITY) ? 0.f : expf(pm - M);
  l = l * c_self + pl * c_other;
  m = M;
}

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
