// The skinny product at the core of the fused decode kernels: a few decode
// lanes (rows of A, produced on the fly by a functor) times a column tile of
// a row-major weight matrix W (K, N) streamed once from device memory.
//
// At decode batch sizes the product is bound by the weight bytes, not by the
// arithmetic, and a single load's latency is far longer than the arithmetic
// it feeds, so the tile is laid out for the load path: each thread owns VEC
// consecutive columns (one LOADB-byte load per row) and walks rows r, r + RG,
// ...; it issues the loads of U rows before it uses any of them, so U loads
// per weight are in flight per thread. The A rows of the current K chunk
// (KC rows: at the callers' 2048 most CTAs stage their whole K range once,
// so few barriers interrupt the weight stream) sit in dynamic shared memory
// as f32; accumulation is f32 in registers. The row groups are merged by
// warp shuffles, then warp by warp in shared memory, always in the same
// order, so results are deterministic.
#pragma once

#include "common.cuh"

namespace repro {

// Dynamic shared memory a kernel needs for its staged A: set it with
// cudaFuncSetAttribute before the launch (above 48 KB).
template <int LB, int KC>
constexpr int a_smem_bytes() { return LB * KC * int(sizeof(float)); }

// out_s[(j * LB + l) * NT + c] = sum_{k in [k0, k1)} a_of(b0 + l, k) *
// Wj[k * N + n0 + c] for the NWT weights W0 (and W1 when NWT == 2), lanes
// b0 <= b0 + l < B and columns n0 + c < N (N a multiple of VEC). a_s holds
// LB * KC floats, out_s NWT * LB * NT floats, both in shared memory. All
// threads of the block call it; it starts and ends with a barrier, so out_s
// can be read right after and until the next call.
template <typename T, int NT, int LOADB, int LB, int NWT, int NTHREADS,
          int U, int KC, class AF>
__device__ __forceinline__ void tile_gemm(const T* __restrict__ W0,
                                          const T* __restrict__ W1, int N,
                                          int k0, int k1, int n0, int b0,
                                          int B, const AF& a_of, float* a_s,
                                          float* out_s) {
  constexpr int VEC = LOADB / int(sizeof(T));
  constexpr int TPR = NT / VEC;            // threads per weight row
  constexpr int RG = NTHREADS / TPR;       // row groups
  static_assert(NT % VEC == 0 && NTHREADS % TPR == 0, "tile shape");
  static_assert(TPR >= 32 || 32 % TPR == 0, "row groups must tile a warp");
  using R = typename Raw<LOADB>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % TPR, r = tid / TPR;
  const int n = n0 + c * VEC;
  const bool col_ok = n < N;

  float acc[NWT][LB][VEC];
#pragma unroll
  for (int j = 0; j < NWT; ++j)
#pragma unroll
    for (int l = 0; l < LB; ++l)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[j][l][v] = 0.f;
  __syncthreads();  // the caller may still be reading the previous out_s
  for (int i = tid; i < NWT * LB * NT; i += NTHREADS) out_s[i] = 0.f;

  for (int kc = k0; kc < k1; kc += KC) {
    const int kn = min(KC, k1 - kc);
    __syncthreads();
    for (int i = tid; i < LB * kn; i += NTHREADS) {
      const int l = i / kn, kk = i % kn;
      a_s[l * KC + kk] = b0 + l < B ? a_of(b0 + l, kc + kk) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int kb = r; kb < kn; kb += RG * U) {
      R raw[U][NWT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kb + u * RG;
        const size_t off = (size_t)(kc + kk) * N + n;
#pragma unroll
        for (int j = 0; j < NWT; ++j) {
          const T* W = j == 0 ? W0 : W1;
          raw[u][j] = kk < kn ? __ldg(reinterpret_cast<const R*>(W + off))
                              : R{};
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kb + u * RG;
        if (kk >= kn) break;
#pragma unroll
        for (int j = 0; j < NWT; ++j) {
          const T* e = reinterpret_cast<const T*>(&raw[u][j]);
          float w[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) w[v] = to_f(e[v]);
#pragma unroll
          for (int l = 0; l < LB; ++l) {
            const float a = a_s[l * KC + kk];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[j][l][v] += a * w[v];
          }
        }
      }
    }
  }

  // merge the row groups that share a warp, then the warps, in fixed order
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < NWT; ++j)
#pragma unroll
      for (int l = 0; l < LB; ++l)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[j][l][v] += __shfl_xor_sync(0xffffffffu, acc[j][l][v], o);
  for (int w = 0; w < NTHREADS / 32; ++w) {
    __syncthreads();
    if (warp == w && lane < TPR) {
#pragma unroll
      for (int j = 0; j < NWT; ++j)
#pragma unroll
        for (int l = 0; l < LB; ++l)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            out_s[(j * LB + l) * NT + c * VEC + v] += acc[j][l][v];
    }
  }
  __syncthreads();
}

}  // namespace repro
