// The backward of causal / windowed GQA flash attention over a whole prompt,
// for Hopper (sm_90a): dq, dk, dv of o = softmax(mask(q k^T * scale)) v.
//
// Replaces: no Pallas kernel. JAX's train step differentiates
// models/layers.py::attention (the XLA block_attention, the pure-JAX
// analogue of kernel.py::flash_prefill) and XLA derives its backward; the
// port's forward is the flash_prefill kernel (prefill.cu), whose result
// has no gradient without this. It follows the flash backward of JAX's
// Pallas TPU kernel: di = rowsum(o * do) once, then a dK/dV kernel and a
// dQ kernel that recompute p from q, k and the forward's row log-sum-exp.
//
// Inputs, all contiguous: q, o, do (B, S, Hq, d) bf16; k, v (B, S, Hkv, d)
// bf16; lse (B, Hq, S) f32 from the LSE form of prefill.cu. Outputs dq
// (B, S, Hq, d), dk, dv (B, S, Hkv, d) bf16. d in 32/64/128, any G = Hq /
// Hkv, any S >= 1; query i attends key j where j <= i (causal) and
// i - j < window (window > 0); at least one of the two.
//   p = exp(q k^T scale - lse), dv = p^T do, dp = do v^T,
//   ds = p (dp - di), dq = scale ds k, dk = scale ds^T q.
//
// Bound: tensor-core operations. The five products over the attended
// pairs, 2 * B * Hq * pairs * (3 dk + 2 dv) flops (s, dp, dv, dq, dk),
// against the bytes of q, k, v, o, do, lse read once and dq, dk, dv
// written once: at the 7B expert's training shape (B 4, S 2048, 32 heads,
// dh 128, causal) 3.437e11 flops and ~539 MB, 0.3475 ms at 989 TFLOP/s.
//
// Design (simple first: mma.sync, cp.async; wgmma and TMA are a later
// redesign):
//  * di_kernel: one warp a (batch, position, q head) row, f32.
//  * dkdv_kernel: one CTA of 4 warps per (batch, kv head, 64-key tile),
//    each warp 16 keys with their dk and dv rows in f32 registers. It walks
//    the G q heads of its kv head and, for each, the 64-row q tiles that
//    see the key tile (from the tile's first key under causal; up to its
//    last key + window - 1 with a window), Q and dO double-buffered by
//    cp.async. Per 32 q rows: s^T = k q^T and dp^T = v do^T (m16n8k16,
//    f32 accumulate), p^T and ds^T in registers, then dv += p^T do and
//    dk += ds^T q with p^T / ds^T rounded to bf16 as the A operand (the
//    accumulator layout is the A fragment's). The G heads' sum stays in
//    the CTA: no atomics.
//  * dq_kernel: one CTA of 4 warps per (batch, q head, 64-row q tile),
//    each warp 16 rows with their dq in f32 registers, walking the 64-key
//    tiles its rows see (K and V double-buffered): s = q k^T and dp = do
//    v^T per 32 keys, ds in registers, dq += ds k.
//  * Shared-memory rows are padded by 16 bytes, so the 8 rows an ldmatrix
//    phase reads fall in distinct banks.
// Deterministic: every output element is summed by one thread in a fixed
// order. Rows and keys past S load as zeros and are masked; nothing past S
// is written.
//
// Where it can go wrong, and what guards it: a fragment mapping that is
// off gives finite, wrong numbers, so the card tests and chip_smoke.py hold
// dq, dk, dv to ref.py::attention_bwd_ref in f32 (each layer of the
// training phase at the model's inputs), with a mask and a di fault
// planted in the reference that the check must catch.
#include "mma_sync.cuh"

using namespace repro;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 64;              // keys per dK/dV CTA; keys per dQ tile
constexpr int BQ = 64;              // q rows per dQ CTA; q rows per dK/dV tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;                   // padded row, elements
  static constexpr int TILE = 64 * LD;               // one 64-row tile
  // dK/dV: K, V, then 2 x (Q, dO); dQ: Q, dO, then 2 x (K, V); and two
  // buffers of 64 f32 pairs (lse * log2e, di) for dK/dV
  static constexpr int BYTES = 6 * TILE * 2 + 2 * 2 * 64 * 4;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(int r, int j, int S, int causal,
                                        int window) {
  return r < S && j < S && (!causal || j <= r) && (!window || r - j < window);
}

// rows [r0, r0 + 64) of a (B, S, H, D) tensor's head h, batch b, into a
// padded shared tile; rows past S are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int h, int H, int S, int r0) {
  constexpr int CH = D / 8;                          // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < S;
    const __nv_bfloat16* g =
        src + (((size_t)b * S + (ok ? row : 0)) * H + h) * D + c * 8;
    cp_async16(dst + r * Smem<D>::LD + c * 8, g, ok);
  }
}

// -------------------------------------------------------------- di
// di[b, h, s] = sum_c o[b, s, h, c] * do[b, s, h, c] in f32: one warp a row
template <int D>
__global__ void __launch_bounds__(256)
di_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout, float* di,
          int S, int Hq, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  constexpr int PER = D / 32;                        // 1, 2 or 4 elements
  float a[PER], c[PER];
  load_span<__nv_bfloat16, PER>(o + row * D + lane * PER, a);
  load_span<__nv_bfloat16, PER>(dout + row * D + lane * PER, c);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) sum += a[i] * c[i];
  sum = warp_sum(sum);
  if (lane == 0) {
    const long long bs = row / Hq;                   // row = (b * S + s) Hq + h
    const int h = (int)(row % Hq), s = (int)(bs % S);
    const long long b = bs / S;
    di[(b * Hq + h) * S + s] = sum;
  }
}

// -------------------------------------------------------------- dK / dV
template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k,
            const __nv_bfloat16* v, const __nv_bfloat16* dout,
            const float* lse, const float* di, __nv_bfloat16* dk,
            __nv_bfloat16* dv, int S, int Hq, int Hkv, int causal,
            int window, float scale) {
  using SM = Smem<D>;
  constexpr int LD = SM::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + SM::TILE;
  __nv_bfloat16* qs = vs + SM::TILE;                 // [2] tiles
  __nv_bfloat16* dos = qs + 2 * SM::TILE;            // [2] tiles
  float* stat = reinterpret_cast<float*>(dos + 2 * SM::TILE);  // [2][2][64]

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = scale * LOG2E;

  // the q rows that see a key of this tile: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(S, k0 + BK - 1 + window) : S;
  const int t_lo = q_lo / BQ, n_t = (q_hi + BQ - 1) / BQ - t_lo;
  const int n_it = G * n_t;                          // (head, q tile) pairs

  auto load_it = [&](int it, int buf) {
    const int h = hk * G + it / n_t, r0 = (t_lo + it % n_t) * BQ;
    load_tile<D>(qs + buf * SM::TILE, q, b, h, Hq, S, r0);
    load_tile<D>(dos + buf * SM::TILE, dout, b, h, Hq, S, r0);
    cp_async_commit();
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int row = r0 + i;
      const size_t at = ((size_t)b * Hq + h) * S + row;
      stat[buf * 128 + i] = row < S ? lse[at] * LOG2E : 0.f;
      stat[buf * 128 + 64 + i] = row < S ? di[at] : 0.f;
    }
  };

  load_tile<D>(ks, k, b, hk, Hkv, S, k0);
  load_tile<D>(vs, v, b, hk, Hkv, S, k0);
  if (n_it > 0) load_it(0, 0);
  else cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int kr0 = warp * 16;                         // the warp's keys
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      load_it(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (t_lo + it % n_t) * BQ;
    const __nv_bfloat16* qb = qs + buf * SM::TILE;
    const __nv_bfloat16* db = dos + buf * SM::TILE;
    const float* lse2 = stat + buf * 128;
    const float* dib = lse2 + 64;
#pragma unroll 1
    for (int sub = 0; sub < BQ / 32; ++sub) {
      const int qr0 = sub * 32;
      float sa[4][4], pa[4][4];                      // s^T, dp^T: 16 x 32
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ak[4], av[4];
        const int ao = (kr0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(ak, ks + ao);
        ldsm_x4(av, vs + ao);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bq[4], bd[4];
          const int bo = (qr0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(bq, qb + bo);
          ldsm_x4(bd, db + bo);
          mma_bf16(sa[2 * np], ak, bq[0], bq[1]);
          mma_bf16(sa[2 * np + 1], ak, bq[2], bq[3]);
          mma_bf16(pa[2 * np], av, bd[0], bd[1]);
          mma_bf16(pa[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // p^T and ds^T: element (key row g or g + 8, q column n * 8 + 2 tig
      // (+1)) of the warp's 16 x 32 block, packed to bf16 as the A
      // fragments of the next products (k = q columns): registers (row g,
      // k 2 tig), (row g + 8, k 2 tig), (row g, k 8 + 2 tig), (row g + 8,
      // k 8 + 2 tig) of each 16 columns
      unsigned ap[2][4], as[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float pe[4], se[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qr0 + n * 8 + tig * 2 + (e & 1);
          const int j = k0 + kr0 + g + (e >> 1) * 8;
          const float p = visible(r0 + qi, j, S, causal, window)
                              ? ex2(fmaf(sa[n][e], sl2, -lse2[qi]))
                              : 0.f;
          pe[e] = p;
          se[e] = p * (pa[n][e] - dib[qi]);
        }
        const int kk2 = n >> 1, hi = (n & 1) * 2;
        ap[kk2][hi] = pack_bf16(pe[0], pe[1]);
        ap[kk2][hi + 1] = pack_bf16(pe[2], pe[3]);
        as[kk2][hi] = pack_bf16(se[0], se[1]);
        as[kk2][hi + 1] = pack_bf16(se[2], se[3]);
      }
      // dv += p^T do, dk += ds^T q: B (q rows x d) read transposed
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {
#pragma unroll
        for (int np2 = 0; np2 < D / 16; ++np2) {
          unsigned bd[4], bq[4];
          const int bo = (qr0 + kk2 * 16 + (lane & 15)) * LD + np2 * 16 +
                         (lane >> 4) * 8;
          ldsm_x4_trans(bd, db + bo);
          ldsm_x4_trans(bq, qb + bo);
          mma_bf16(dva[2 * np2], ap[kk2], bd[0], bd[1]);
          mma_bf16(dva[2 * np2 + 1], ap[kk2], bd[2], bd[3]);
          mma_bf16(dka[2 * np2], as[kk2], bq[0], bq[1]);
          mma_bf16(dka[2 * np2 + 1], as[kk2], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();              // the buffer is refilled next iteration
  }

  // the warp's 16 keys: rows g and g + 8, columns n * 8 + 2 tig (+1)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = k0 + kr0 + g + hr * 8;
    if (j >= S) continue;
    const size_t at = (((size_t)b * S + j) * Hkv + hk) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<unsigned*>(dk + at + n * 8) =
          pack_bf16(dka[n][2 * hr] * scale, dka[n][2 * hr + 1] * scale);
      *reinterpret_cast<unsigned*>(dv + at + n * 8) =
          pack_bf16(dva[n][2 * hr], dva[n][2 * hr + 1]);
    }
  }
}

// -------------------------------------------------------------- dQ
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k,
          const __nv_bfloat16* v, const __nv_bfloat16* dout,
          const float* lse, const float* di, __nv_bfloat16* dq, int S,
          int Hq, int Hkv, int causal, int window, float scale) {
  using SM = Smem<D>;
  constexpr int LD = SM::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + SM::TILE;
  __nv_bfloat16* ks = dos + SM::TILE;                // [2] tiles
  __nv_bfloat16* vs = ks + 2 * SM::TILE;             // [2] tiles

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = scale * LOG2E;

  // the keys the tile's rows see: [k_lo, k_hi)
  const int k_lo = window ? max(q0 - window + 1, 0) : 0;
  const int k_hi = causal ? min(q0 + BQ, S) : S;
  const int t_lo = k_lo / BK, n_t = (k_hi + BK - 1) / BK - t_lo;

  auto load_kv = [&](int t, int buf) {
    load_tile<D>(ks + buf * SM::TILE, k, b, hk, Hkv, S, (t_lo + t) * BK);
    load_tile<D>(vs + buf * SM::TILE, v, b, hk, Hkv, S, (t_lo + t) * BK);
    cp_async_commit();
  };
  load_tile<D>(qs, q, b, h, Hq, S, q0);
  load_tile<D>(dos, dout, b, h, Hq, S, q0);
  if (n_t > 0) load_kv(0, 0);
  else cp_async_commit();

  const int qr0 = warp * 16;                         // the warp's rows
  float lse2[2], dib[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + qr0 + g + hr * 8;
    const size_t at = ((size_t)b * Hq + h) * S + r;
    lse2[hr] = r < S ? lse[at] * LOG2E : 0.f;
    dib[hr] = r < S ? di[at] : 0.f;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_t) {
      load_kv(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kb0 = (t_lo + t) * BK;
    const __nv_bfloat16* kb = ks + buf * SM::TILE;
    const __nv_bfloat16* vb = vs + buf * SM::TILE;
#pragma unroll 1
    for (int sub = 0; sub < BK / 32; ++sub) {
      const int kc0 = sub * 32;
      float sa[4][4], pa[4][4];                      // s, dp: 16 x 32
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = pa[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned aq[4], ad[4];
        const int ao = (qr0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(aq, qs + ao);
        ldsm_x4(ad, dos + ao);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bk[4], bv[4];
          const int bo = (kc0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(bk, kb + bo);
          ldsm_x4(bv, vb + bo);
          mma_bf16(sa[2 * np], aq, bk[0], bk[1]);
          mma_bf16(sa[2 * np + 1], aq, bk[2], bk[3]);
          mma_bf16(pa[2 * np], ad, bv[0], bv[1]);
          mma_bf16(pa[2 * np + 1], ad, bv[2], bv[3]);
        }
      }
      unsigned as[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float se[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int r = q0 + qr0 + g + hr * 8;
          const int j = kb0 + kc0 + n * 8 + tig * 2 + (e & 1);
          const float p = visible(r, j, S, causal, window)
                              ? ex2(fmaf(sa[n][e], sl2, -lse2[hr]))
                              : 0.f;
          se[e] = p * (pa[n][e] - dib[hr]);
        }
        const int kk2 = n >> 1, hi = (n & 1) * 2;
        as[kk2][hi] = pack_bf16(se[0], se[1]);
        as[kk2][hi + 1] = pack_bf16(se[2], se[3]);
      }
      // dq += ds k: B (keys x d) read transposed
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {
#pragma unroll
        for (int np2 = 0; np2 < D / 16; ++np2) {
          unsigned bk[4];
          const int bo = (kc0 + kk2 * 16 + (lane & 15)) * LD + np2 * 16 +
                         (lane >> 4) * 8;
          ldsm_x4_trans(bk, kb + bo);
          mma_bf16(dqa[2 * np2], as[kk2], bk[0], bk[1]);
          mma_bf16(dqa[2 * np2 + 1], as[kk2], bk[2], bk[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + qr0 + g + hr * 8;
    if (r >= S) continue;
    const size_t at = (((size_t)b * S + r) * Hq + h) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(dq + at + n * 8) =
          pack_bf16(dqa[n][2 * hr] * scale, dqa[n][2 * hr + 1] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* di, void* dq, void* dk,
           void* dv, int B, int S, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const long long rows = (long long)B * S * Hq;
  di_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), di, S, Hq,
      rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int SMEM = Smem<D>::BYTES;
  e = cudaFuncSetAttribute(dkdv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<D><<<dim3((S + BK - 1) / BK, Hkv, B), THREADS, SMEM, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, di,
      static_cast<bf*>(dk), static_cast<bf*>(dv), S, Hq, Hkv, causal, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<D><<<dim3((S + BQ - 1) / BQ, Hq, B), THREADS, SMEM, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, di,
      static_cast<bf*>(dq), S, Hq, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// di (B, Hq, S) f32 is the caller's scratch; every other pointer is a
// contiguous tensor as described above
extern "C" int flash_prefill_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, int B, int S, int Hq, int Hkv, int d, int causal, int window,
    float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv || !(causal || window) ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, dout, lse, di, dq, dk, dv, B, S,
                               Hq, Hkv, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, di, dq, dk, dv, B, S,
                               Hq, Hkv, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, di, dq, dk, dv, B, S,
                                 Hq, Hkv, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the dynamic shared memory one CTA of either kernel takes at head width d
extern "C" int flash_prefill_bwd_smem_bytes(int d) {
  switch (d) {
    case 32: return Smem<32>::BYTES;
    case 64: return Smem<64>::BYTES;
    case 128: return Smem<128>::BYTES;
  }
  return 0;
}

REPRO_EXPORT_ERROR_STRING
