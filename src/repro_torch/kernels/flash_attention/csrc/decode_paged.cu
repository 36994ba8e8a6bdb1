// Paged GQA flash-decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_decode_paged
// (_decode_paged_kernel), reached through flash_attention/ops.py::decode_paged.
//
// Computes, for every lane b and kv head h, the G grouped queries
// q[b,h,:,:] (pre-scaled by 1/sqrt(dh)) against the lane's cached keys and
// values, gathered position by position through the block table
// tables[b, t / block] of the paged pools (rows, block, Hkv, dh), masked to
// the first len1[b] positions, with an online softmax (m, l, acc) in f32.
// A lane whose len1 points at padding rows produces finite garbage that the
// caller ignores, as on the TPU.
//
// Bound: device-memory bytes. Each cached token costs Hkv*dh*2 elements of
// K and V and is read once; at decode batch sizes there is nothing to reuse,
// so the least time is (K+V bytes of the lanes' len1 + q + out) / 3.35 TB/s.
//
// Design: one CTA of 8 warps per (lane, kv head) - 256 CTAs at the 7B width
// and B = 8. The TPU walked the block table along a sequential grid axis with
// the softmax state in VMEM; here the CTA's warps split the positions. A
// token's K row is dh elements, EPL per thread, so a warp serves
// 32 / (dh / EPL) tokens at once (4 at dh = 128, bf16); every group of
// threads keeps its own online-softmax state (m, l, acc) in registers and
// loads its next token's K and V before it uses the current ones, so each
// warp has 8 tokens' loads in flight. The states are merged by shuffles
// within the warp, then warp by warp in shared memory, in a fixed order.
// Split-K across CTAs for contexts far longer than the pool's 512 comes
// later.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int NWARPS = 8;

__device__ __forceinline__ void merge_state(float& m, float& l, float pm,
                                            float pl, float& c_self,
                                            float& c_other) {
  const float M = fmaxf(m, pm);
  c_self = (m == -INFINITY) ? 0.f : expf(m - M);
  c_other = (pm == -INFINITY) ? 0.f : expf(pm - M);
  l = l * c_self + pl * c_other;
  m = M;
}

template <typename T, int DH, int GT, int EPL>
__global__ void __launch_bounds__(NWARPS * 32)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ len1, T* __restrict__ out, int Hkv,
                    int block, int maxb, float scale) {
  constexpr int LPT = DH / EPL;       // threads per token
  constexpr int TPW = 32 / LPT;       // tokens per warp step
  static_assert(DH % EPL == 0 && 32 % LPT == 0, "head split");
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPT, gl = lane % LPT;

  float qf[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    load_span<T, EPL>(q + ((size_t)(b * Hkv + h) * GT + g) * DH + gl * EPL,
                      qf[g]);
#pragma unroll
    for (int i = 0; i < EPL; ++i) qf[g][i] *= scale;
  }

  int L = len1[b];
  if (L > maxb * block) L = maxb * block;
  const int* tb = tables + (size_t)b * maxb;
  const size_t tok_stride = (size_t)Hkv * DH;
  auto addr = [&](int t) {
    return ((size_t)tb[t / block] * block + (t % block)) * tok_stride +
           (size_t)h * DH + gl * EPL;
  };

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
  T* o = out + (size_t)(b * Hkv + h) * GT * DH;
  for (int i = threadIdx.x; i < GT * DH; i += blockDim.x) {
    const int g = i / DH;
    o[i] = from_f<T>((&sm_acc[0][0])[i] / fmaxf(sm_l[g], 1e-30f));
  }
}

template <typename T, int DH, int GT>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* len1, void* out, int B, int Hkv, int block, int maxb,
           float scale, cudaStream_t stream) {
  constexpr int EPL = GT <= 2 ? 16 : 8;
  decode_paged_kernel<T, DH, GT, EPL><<<B * Hkv, NWARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(len1), static_cast<T*>(out), Hkv, block, maxb,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int by_group(int G, const void* q, const void* kp, const void* vp,
             const void* tables, const void* len1, void* out, int B, int Hkv,
             int block, int maxb, float scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, DH, 1>(q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    case 2: return launch<T, DH, 2>(q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    case 4: return launch<T, DH, 4>(q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    case 8: return launch<T, DH, 8>(q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* tables,
             const void* len1, void* out, int B, int Hkv, int G, int dh,
             int block, int maxb, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return by_group<T, 32>(G, q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    case 64: return by_group<T, 64>(G, q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    case 128: return by_group<T, 128>(G, q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    case 256: return by_group<T, 256>(G, q, kp, vp, tables, len1, out, B, Hkv, block, maxb, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int decode_paged_bf16(const void* q, const void* kp, const void* vp,
                                 const void* tables, const void* len1,
                                 void* out, int B, int Hkv, int G, int dh,
                                 int block, int maxb, float scale,
                                 void* stream) {
  return dispatch<__nv_bfloat16>(q, kp, vp, tables, len1, out, B, Hkv, G, dh,
                                 block, maxb, scale, stream);
}

REPRO_EXPORT_ERROR_STRING
