// Causal / sliding-window GQA flash attention over a whole prompt, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_prefill
// (_prefill_kernel), reached through flash_attention/ops.py::attention.
//
// Computes o (B, S, Hq, dh) = softmax(mask(q k^T * scale)) v for bf16
// q (B, S, Hq, dh) and k / v (B, S, Hkv, dh), q head h reading kv head
// h / (Hq / Hkv). Query i attends key j where j <= i (causal) and
// i - j < window (window > 0). All four tensors are read and written by
// their (batch, position, head) strides; head_dim is contiguous. Any
// S >= 1: the Pallas kernel asserts S % 128 == 0, this one masks the ragged
// tail itself and never reads past S.
//
// Bound: tensor-core operations. 4 * B * Hq * dh * pairs flops, pairs =
// sum_i min(i + 1, W) (W = S without a window), against 2 * B * S *
// (2 Hq + 2 Hkv) * dh bytes: at the 7B widths (B 8, S 2048, 32 heads,
// dh 128, causal) 2.75e11 flops and 537 MB, 0.278 ms at 989 TFLOP/s; at
// RecurrentGemma's (B 4, S 3000, 16 q heads on 1 kv head, dh 256, window
// 2048) 2.65e11 flops and 209 MB, 0.268 ms.
//
// Design: FlashAttention-2 on warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulate) for both q k^T and p v. One CTA of 4 warps per (batch, q
// head, 64-row q tile), each warp owning 16 rows; the TPU streamed K/V
// blocks through VMEM along a sequential fori_loop, here the CTA walks the
// K/V tiles of its band [lo, hi) -- the same bounds as the Pallas kernel
// (causal: keys up to the tile's last row; window: from its first row's
// window start) -- so tiles outside the band are never loaded. K/V tiles
// are double-buffered in shared memory with cp.async (16-byte copies, rows
// past S zero-filled), fragments come from shared memory by ldmatrix (rows
// padded by 8 elements, so the 8 rows of each 8x8 matrix fall in distinct
// banks), and the online softmax state (m, l) stays in registers. Masks are
// applied only on tiles that cross the diagonal, the window's edge or S.
// Heavier (later) causal q tiles are scheduled first. At dh = 256 the
// key tile is 32 wide so that the f32 accumulator (128 per thread) and the
// scores fit in registers; the shared memory (above 48 KB at dh >= 128)
// is opted in with cudaFuncSetAttribute.
//
// Two numerical choices: scores are scaled in f32 AFTER the bf16 product,
// as JAX's _gqa_scores does (the Pallas kernel scales q in f32 first, which
// bf16 tensor-core inputs cannot mirror); p is rounded to bf16 before the
// p v product, as both JAX versions do, while l sums the f32 p.
#include "mma_sync.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;            // q rows per CTA
constexpr int NWARPS = BQ / 16;   // one warp per 16 rows
constexpr int PAD = 8;            // bf16 elements of padding per smem row

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, s, h;              // elements
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int S, G, causal, window;
  Strides sq, sk, sv, so;
  float scale;
};

// ROWS rows of DH elements starting at position row0 of one (batch, head)
// into shared memory (row stride DH + PAD); rows at or past S are zeroed.
template <int DH, int ROWS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, int row0,
                                          int S, long long stride) {
  constexpr int CPR = DH / 8;     // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += NWARPS * 32) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < S;
    const bf16* src = g + (ok ? (long long)(row0 + r) * stride : 0) + c * 8;
    cp_async16(sm + r * (DH + PAD) + c * 8, src, ok);
  }
}

template <int DH, int BK>
constexpr int smem_bytes() {
  return (BQ + 4 * BK) * (DH + PAD) * (int)sizeof(bf16);
}

template <int DH, int BK>
__global__ void __launch_bounds__(NWARPS * 32)
prefill_kernel(const Args p) {
  constexpr int LD = DH + PAD;
  constexpr int NT = BK / 8;      // score n-tiles per warp
  constexpr int OT = DH / 8;      // output n-tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;                     // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                 // [2][BK][LD]

  const int S = p.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  const bf16* qg = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* kg = p.k + b * p.sk.b + hk * p.sk.h;
  const bf16* vg = p.v + b * p.sv.b + hk * p.sv.h;

  // the band of keys any row of this tile attends: [lo, hi)
  const int hi = p.causal ? min(q0 + BQ, S) : S;
  const int lo = p.window ? max(q0 - p.window + 1, 0) : 0;
  const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;

  load_rows<DH, BQ>(Qs, qg, q0, S, p.sq.s);
  load_rows<DH, BK>(Ks, kg, t_lo * BK, S, p.sk.s);
  load_rows<DH, BK>(Vs, vg, t_lo * BK, S, p.sv.s);
  cp_async_commit();

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* q_frag = Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LD + (lane >> 4) * 8;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      const int nxt = stage ^ 1;
      load_rows<DH, BK>(Ks + nxt * BK * LD, kg, (t + 1) * BK, S, p.sk.s);
      load_rows<DH, BK>(Vs + nxt * BK * LD, vg, (t + 1) * BK, S, p.sv.s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;

    // s = q k^T for this warp's 16 rows x BK keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, q_frag + kk * 16);
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        unsigned bfr[4];
        ldsm_x4(bfr, Kt + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nn], a, bfr[0], bfr[1]);
        mma_bf16(s[2 * nn + 1], a, bfr[2], bfr[3]);
      }
    }

    // scale; mask only the tiles that cross the diagonal, window or S
    const int k0 = t * BK;
    const bool need_mask = (p.causal && k0 + BK - 1 > q0) ||
                           (p.window && q0 + BQ - 1 - k0 >= p.window) ||
                           k0 + BK > S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (need_mask) {
          const int r = row[e >> 1], c = k0 + j * 8 + tig * 2 + (e & 1);
          if (c >= S || (p.causal && c > r) ||
              (p.window && r - c >= p.window))
            x = -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3); the four
    // threads of a quad share a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m[hr] == -INFINITY) ? 0.f : __expf(m[hr] - m_use);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float pe = __expf(s[j][e] - m_use);
          s[j][e] = pe;
          sum += pe;
        }
      l[hr] = l[hr] * alpha + sum;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }

    // o += p v: the score accumulators, rounded to bf16, are p's A
    // fragments; v's B fragments come transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        unsigned bfr[4];
        ldsm_x4_trans(bfr, Vt + (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                               dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], a, bfr[0], bfr[1]);
        mma_bf16(o[2 * dn + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();              // the stage is refilled next iteration
  }

  // normalise and write the rows below S
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    if (row[hr] < S) {
      bf16* dst = p.o + b * p.so.b + row[hr] * p.so.s + h * p.so.h + tig * 2;
#pragma unroll
      for (int j = 0; j < OT; ++j)
        *reinterpret_cast<unsigned*>(dst + j * 8) =
            pack_bf16(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
    }
  }
}

template <int DH, int BK>
int launch(const Args& a, int B, int Hq, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH, BK>();
  // above 48 KB of dynamic shared memory only after this opt-in (set on
  // every launch: it is per device and costs no device time)
  const cudaError_t e = cudaFuncSetAttribute(
      prefill_kernel<DH, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.S + BQ - 1) / BQ, Hq, B);
  prefill_kernel<DH, BK><<<grid, NWARPS * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Hq, int Hkv, int dh, int causal, int window, int sqb, int sqs,
    int sqh, int skb, int sks, int skh, int svb, int svs, int svh, int sob,
    int sos, int soh, float scale, void* stream) {
  if (S < 1 || Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Hq / Hkv,
         causal, window, {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh},
         {sob, sos, soh}, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32, 64>(a, B, Hq, st);
    case 64: return launch<64, 64>(a, B, Hq, st);
    case 128: return launch<128, 64>(a, B, Hq, st);
    case 256: return launch<256, 32>(a, B, Hq, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_EXPORT_ERROR_STRING
