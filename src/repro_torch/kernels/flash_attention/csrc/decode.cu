// Dense-cache GQA flash-decode for Hopper (sm_90a): the whole GQA group a
// CTA on tensor cores, the cache split along S, a deterministic merge.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_decode
// (_decode_kernel), reached through flash_attention/ops.py::decode.
//
// Computes o (B, Hq, dh) for queries q (B, Hq, dh) against the dense caches
// k / v (B, S, Hkv, dh), attending the first L = min(length, S) positions
// (one length shared by the batch, a host int). Positions at or past L are
// never read.
//
// Bound: device-memory bytes: (K+V bytes of B * L positions + q + out) /
// 3.35 TB/s. At decode batch sizes nothing is reused across lanes, so the
// design is about reading each K / V row once and keeping the memory
// streaming on every SM.
//
//  * The group a CTA, on tensor cores. CTA (pair, c) serves the G queries
//    of one (lane b, kv head h) as the 16 rows of one m16n8k16 tile (rows
//    past G zero), so each K / V row crosses the memory once whatever G.
//    G > 16 takes ceil(G / 16) tiles, each in a sibling CTA of its own
//    (no config has G > 16). S = Q K^T and O += P V run on mma.sync, bf16
//    in, f32 accumulators; P is rounded to bf16 before P V, as the plain
//    version rounds its probabilities to the cache's dtype (and the TPU
//    kernel its p). wgmma's 64-row M would leave 48-63 of its rows dead at
//    these G, and the kernel is bound by bytes, not operations: mma.sync's
//    16 rows are enough.
//  * A split along S. CTA (pair, c) takes positions [c C, min(L, (c + 1) C))
//    of its pair, C = chunk, a host int the wrapper picks
//    (ops.py::decode_plan) from (B, Hkv, G, L, the card's SMs): about one
//    CTA for every two SMs, since a CTA's fixed costs outweigh what more
//    CTAs stream at these sizes (PERF.md); every chunk is non-empty.
//    x = pair * chunks + c, the chunks of a pair adjacent, so merges spread
//    over the run.
//  * Copy rings, one a warp. The chunk's positions go to the 4 warps in
//    slices of 16, round robin (slice x of warp w: positions (4 x + w) 16
//    + r), and each warp streams its slices through its own ring of RING
//    slots in shared memory: each slice's K and V rows copied by 16-byte
//    cp.async (zero-filled past the chunk's end, so nothing past L is
//    read), one commit group a slice, a slot refilled as soon as the warp
//    has consumed it; the warps never wait on each other until the
//    chunk's end. 64 KB in flight per CTA at dh 128. Where the grid gives
//    every SM a CTA (the plan's l1: streaming, bound by bytes) the copies
//    are cp.async.ca, which allocate in L1 on the way: row 6 ran 5 %
//    faster so, the smaller rows 6' 3-8 % slower (PERF.md). (A ring
//    shared by the CTA, a barrier a stage, was no faster on an H100 and
//    took 255 registers and a spill at dh 256, where this takes 222;
//    deeper or shallower rings, 2 or 8 warps, L2 prefetch and evict-first
//    hints were no faster at row 6: PERF.md.) Rows are stored
//    XOR-swizzled by 16-byte vector, so the eight rows an ldmatrix reads
//    lie in distinct banks.
//  * Each warp's slice: S (16 x 16) from ldmatrix fragments of Q and K,
//    masked past the chunk's end, its own online softmax (m, l in the
//    log2 domain; l summed from f32 p), P V with V's fragments by
//    ldmatrix.trans. At the chunk's end the warps' states merge in warp
//    order through shared memory: the chunk's partial.
//  * A deterministic merge. A pair with one chunk writes o = acc / l.
//    Otherwise every CTA stores its partial (acc, m, l of its live rows) in
//    its slot of the workspace, and the last CTA of the pair to arrive - a
//    per-pair counter, added to with release / acquire semantics at device
//    scope and reset by that CTA - merges the pair's partials in chunk
//    order: M = max m_c, o = sum_c acc_c 2^(m_c - M) / sum_c l_c 2^(m_c -
//    M). It brings every chunk's m and l into shared memory in one round of
//    loads and forms each chunk's weight once, then sums acc with 16 loads
//    in flight a thread: a pair's merge costs a few L2 round trips, not one
//    a chunk. At most 256 chunks a pair. No atomics touch values: two
//    launches agree bit for bit.
//
// decode_split_ref in flash_attention/ref.py is this arithmetic written
// plainly (its partials per chunk; the order of the sums within a chunk,
// and the running max p is taken against, differ).
#include <type_traits>

#include "mma_sync.cuh"

using namespace repro;

namespace {

using bf16 = __nv_bfloat16;

constexpr int DD_WARPS = 4;
constexpr int DD_THREADS = DD_WARPS * 32;
constexpr int DD_ROWS = 16;                   // query rows of a CTA
constexpr int DD_SLICE = 16;                  // positions a warp's slice
constexpr int DD_STAGE = DD_WARPS * DD_SLICE; // positions a round of slices
constexpr int DD_MAX_CHUNKS = 256;            // chunks a pair, at most
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the CTA: the warps' rings of K and V slices, then the
// Q tile (bf16, swizzled). At the chunk's end the warps' states reuse the
// rings: acc (WARPS, 16, DH), then m and l (WARPS, 16), f32; then the
// merge's m, l and weights (256, 16) each, f32, reuse rings and tile.
template <int DH>
struct Dense {
  static constexpr int D8 = DH / 8;                    // 16-byte vectors a row
  static constexpr int RING = DH <= 64 ? 4 : 3;
  static constexpr int SLICE = DD_SLICE * DH;          // elements of K (of V)
  static constexpr int STAGE = DD_WARPS * SLICE;
  static constexpr int BYTES = (2 * RING * STAGE + DD_ROWS * DH) * 2;
  static_assert(DH % 16 == 0 && (D8 == 4 || D8 % 8 == 0), "head width");
  static_assert(DD_WARPS * DD_ROWS * (DH + 2) * 4 <= 2 * RING * STAGE * 2,
                "warp states in the ring");
  static_assert((2 * DD_MAX_CHUNKS + 1) * DD_ROWS * 4 <= BYTES,
                "the merge's weights in shared memory");
};

// Element offset of 16-byte vector v of row r in a tile of D8 vectors a
// row, XOR-swizzled: the eight rows an ldmatrix reads (r..r+7, one v) fall
// in eight distinct 16-byte bank groups.
template <int D8>
__device__ __forceinline__ int swz(int r, int v) {
  const int sv = D8 >= 8 ? v ^ (r & 7) : v ^ ((r >> 1) & 3);
  return (r * D8 + sv) * 8;
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void store_bf16x4(bf16* p, float4 v) {
  uint2 r;
  r.x = pack_bf16(v.x, v.y);
  r.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ void fma4(float4& a, const float4& b, float e) {
  a.x += b.x * e;
  a.y += b.y * e;
  a.z += b.z * e;
  a.w += b.w * e;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes global -> shared, zero-filled where !valid (nothing read): with
// L1, cp.async.ca, which allocates the lines in L1 on the way, else
// cp.async.cg (L2 only; mma_sync.cuh's cp_async16)
template <bool L1>
__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       bool valid) {
  if constexpr (L1) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0));
  } else {
    cp_async16(smem, gmem, valid);
  }
}

// q, out: (B, Hkv * G, DH); kc, vc: (B, S, Hkv, DH); part: (pairs, nc,
// slot) floats, slot = min(G, 16) * (DH + 2) rounded up to 4; counters:
// (pairs) ints, zero between launches. pair = (b * Hkv + h) * tiles + tile.
// scale2 = log2(e) / sqrt(DH). L1: the K / V copies allocate in L1.
template <int DH, bool L1>
__global__ void __launch_bounds__(DD_THREADS)
decode_group_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, bf16* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    int S, int Hkv, int G, int L, int chunk, int nc,
                    float scale2) {
  using D = Dense<DH>;
  constexpr int D8 = D::D8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = blockIdx.x / nc, c = blockIdx.x % nc;
  const int tiles = (G + DD_ROWS - 1) / DD_ROWS;
  const int tile = pair % tiles, bh = pair / tiles;
  const int b = bh / Hkv, h = bh % Hkv;
  const int rows = min(DD_ROWS, G - tile * DD_ROWS);     // live query rows
  const int t0 = c * chunk;
  const int nv = min(chunk, L - t0);                     // >= 1: c < nc
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);        // (RING, K | V)
  bf16* qs = ring + 2 * D::RING * D::STAGE;              // (16, DH)
  __shared__ int last;

  // the Q tile, a commit group of its own ahead of the ring's
  const bf16* qb = q + ((size_t)bh * G + tile * DD_ROWS) * DH;
  for (int i = tid; i < DD_ROWS * D8; i += DD_THREADS) {
    const int r = i / D8, v = i % D8;
    const bool ok = r < rows;
    cp_async16(qs + swz<D8>(r, v), ok ? qb + r * DH + v * 8 : qb, ok);
  }
  cp_async_commit();

  // slice x of this warp: chunk positions p(x) = (x * WARPS + warp) * 16
  // + r, r < 16, into slot x % RING of the warp's own ring
  bf16* wring = ring + warp * D::RING * 2 * D::SLICE;
  const int nsw = nv > warp * DD_SLICE
                      ? (nv - warp * DD_SLICE + DD_STAGE - 1) / DD_STAGE
                      : 0;                               // its slices
  const size_t tok = (size_t)Hkv * DH;
  const size_t base = (size_t)b * S * tok + (size_t)h * DH + (size_t)t0 * tok;
  constexpr int SV = DD_SLICE * D8;                      // vectors a slice
  static_assert(SV % 32 == 0, "slice split");
  auto issue = [&](int x) {
    if (x < nsw) {
      bf16* ks = wring + (x % D::RING) * 2 * D::SLICE;
      bf16* vs = ks + D::SLICE;
      const int p0 = (x * DD_WARPS + warp) * DD_SLICE;
#pragma unroll
      for (int j = 0; j < SV / 32; ++j) {
        const int i = lane + j * 32;
        const int r = i / D8, v = i % D8;
        const bool ok = p0 + r < nv;
        const size_t off = ok ? base + (size_t)(p0 + r) * tok + v * 8 : 0;
        copy16<L1>(ks + swz<D8>(r, v), kc + off, ok);
        copy16<L1>(vs + swz<D8>(r, v), vc + off, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int x = 0; x < D::RING - 1; ++x) issue(x);
  cp_async_wait<D::RING - 1>();                          // the Q tile
  __syncthreads();

  // this thread's rows of the tile, g0 = lane / 4 and g0 + 8, and its two
  // columns 2 (lane % 4) + {0, 1} of each 8-wide fragment
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // ldmatrix row addresses: Q as A (rows, k), K as B (positions, k), V as
  // B transposed (positions, n)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_hi = lane >> 4;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_hi = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_hi = lane >> 4;

  // ---- the warp's ring: wait for slice x, refill the slot slice x - 1
  // used, then take slice x's 16 positions; no CTA barrier
  for (int x = 0; x < nsw; ++x) {
    cp_async_wait<D::RING - 2>();
    __syncwarp();
    issue(x + D::RING - 1);
    const int p0 = (x * DD_WARPS + warp) * DD_SLICE;     // chunk-relative
    const bf16* ks = wring + (x % D::RING) * 2 * D::SLICE;
    const bf16* vs = ks + D::SLICE;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      unsigned a[4], kb[4];
      ldsm_x4(a, qs + swz<D8>(a_row, kk * 2 + a_hi));
      ldsm_x4(kb, ks + swz<D8>(k_row, kk * 2 + k_hi));
      mma_bf16(s[0], a, kb[0], kb[1]);
      mma_bf16(s[1], a, kb[2], kb[3]);
    }
    // scale, mask past the chunk's end, the rows' new maxima
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = p0 + j * 8 + 2 * (lane & 3) + e < nv;
        s[j][e] = ok ? s[j][e] * scale2 : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * scale2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    const float n0 = fmaxf(m0, quad_max(mx0));           // finite: p0 < nv
    const float n1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - n0);
        s[j][2 + e] = exp2f(s[j][2 + e] - n1);
        ps0 += s[j][e];
        ps1 += s[j][2 + e];
      }
    l0 = l0 * al0 + ps0;                 // this thread's columns; the quad
    l1 = l1 * al1 + ps1;                 // sums them at the chunk's end
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // P (16 x 16 positions) as the A fragment, rounded to bf16
    const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) {
      unsigned vb[4];
      ldsm_x4_trans(vb, vs + swz<D8>(v_row, jj * 2 + v_hi));
      mma_bf16(o[2 * jj], pa, vb[0], vb[1]);
      mma_bf16(o[2 * jj + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // ---- the warps' states, merged in warp order
  __syncthreads();                                       // the ring is free
  float* wacc = reinterpret_cast<float*>(ring);          // (W, 16, DH)
  float* wm = wacc + DD_WARPS * DD_ROWS * DH;            // (W, 16)
  float* wl = wm + DD_WARPS * DD_ROWS;
  {
    const int g0 = lane >> 2, col = 2 * (lane & 3);
    float* a0 = wacc + (warp * DD_ROWS + g0) * DH + col;
    float* a1 = a0 + 8 * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<float2*>(a0 + n * 8) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(a1 + n * 8) = make_float2(o[n][2], o[n][3]);
    }
    if ((lane & 3) == 0) {
      wm[warp * DD_ROWS + g0] = m0;
      wm[warp * DD_ROWS + g0 + 8] = m1;
      wl[warp * DD_ROWS + g0] = l0;
      wl[warp * DD_ROWS + g0 + 8] = l1;
    }
  }
  __syncthreads();
  const int N4 = rows * DH / 4;                          // float4s of acc
  // the chunk's acc of float4 e4 of the live rows, and its row's m and l
  auto chunk_state = [&](int e4, float& M, float& lc) {
    const int g = e4 * 4 / DH;
    M = -INFINITY;
#pragma unroll
    for (int w = 0; w < DD_WARPS; ++w) M = fmaxf(M, wm[w * DD_ROWS + g]);
    lc = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DD_WARPS; ++w) {
      const float mw = wm[w * DD_ROWS + g];
      const float e = mw == -INFINITY ? 0.f : exp2f(mw - M);
      lc += wl[w * DD_ROWS + g] * e;
      fma4(a, reinterpret_cast<const float4*>(wacc + w * DD_ROWS * DH)[e4],
           e);
    }
    return a;
  };

  bf16* ob = out + ((size_t)bh * G + tile * DD_ROWS) * DH;
  if (nc == 1) {
    for (int e4 = tid; e4 < N4; e4 += DD_THREADS) {
      float M, lc;
      const float4 a = chunk_state(e4, M, lc);
      lc = fmaxf(lc, 1e-30f);
      store_bf16x4(ob + e4 * 4,
                   make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc));
    }
    return;
  }

  // ---- this chunk's partial to its slot; the pair's last CTA merges
  const int R = min(G, DD_ROWS);
  const int slot_f = (R * (DH + 2) + 3) / 4 * 4;
  float* pb = part + (size_t)pair * nc * slot_f;
  float* slot = pb + (size_t)c * slot_f;
  for (int e4 = tid; e4 < N4; e4 += DD_THREADS) {
    float M, lc;
    const float4 a = chunk_state(e4, M, lc);
    __stcg(reinterpret_cast<float4*>(slot) + e4, a);
    if (e4 * 4 % DH == 0) {
      __stcg(slot + R * DH + e4 * 4 / DH, M);
      __stcg(slot + R * DH + R + e4 * 4 / DH, lc);
    }
  }
  __syncthreads();                  // the CTA's stores before the release
  if (tid == 0) {
    last = atom_add_acq_rel(counters + pair, 1) == nc - 1;
    if (last) counters[pair] = 0;               // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  // the pair's m and l in shared memory (rings and Q tile are free), one
  // load each a thread; then, a thread a row, each chunk's weight
  // 2^(m_c - M) in place of its m, and 1 / sum_c l_c 2^(m_c - M), in
  // chunk order
  float* cm = reinterpret_cast<float*>(ring);            // (nc, 16)
  float* cl = cm + DD_MAX_CHUNKS * DD_ROWS;              // (nc, 16)
  float* rinv = cl + DD_MAX_CHUNKS * DD_ROWS;            // (16)
#pragma unroll 4
  for (int i = tid; i < nc * rows; i += DD_THREADS) {
    const int k = i / rows, g = i % rows;
    const float* sk = pb + (size_t)k * slot_f + R * DH;
    cm[k * DD_ROWS + g] = __ldcg(sk + g);
    cl[k * DD_ROWS + g] = __ldcg(sk + R + g);
  }
  __syncthreads();
  if (tid < rows) {
    float M = -INFINITY;
    for (int k = 0; k < nc; ++k) M = fmaxf(M, cm[k * DD_ROWS + tid]);
    float lt = 0.f;
    for (int k = 0; k < nc; ++k) {
      const float m = cm[k * DD_ROWS + tid];
      const float e = m == -INFINITY ? 0.f : exp2f(m - M);
      cm[k * DD_ROWS + tid] = e;
      lt += cl[k * DD_ROWS + tid] * e;
    }
    rinv[tid] = 1.f / fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  // each thread's float4s of acc summed in chunk order, KB chunks of all
  // of them loaded at once: E * KB = 16 loads in flight a thread (8 at dh
  // 256, whose E = 8 float4s a thread would spill at 16)
  constexpr int E = (DD_ROWS * DH / 4 + DD_THREADS - 1) / DD_THREADS;
  constexpr int KB = E >= 8 ? 1 : 16 / E;
  float4 a[E];
#pragma unroll
  for (int j = 0; j < E; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += KB) {
    float4 ak[KB][E];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (k0 + kb < nc && tid + j * DD_THREADS < N4)
          ak[kb][j] = __ldcg(reinterpret_cast<const float4*>(
                                 pb + (size_t)(k0 + kb) * slot_f) +
                             tid + j * DD_THREADS);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (k0 + kb < nc && tid + j * DD_THREADS < N4)
          fma4(a[j], ak[kb][j],
               cm[(k0 + kb) * DD_ROWS + (tid + j * DD_THREADS) * 4 / DH]);
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e4 = tid + j * DD_THREADS;
    if (e4 < N4) {
      const float r = rinv[e4 * 4 / DH];
      store_bf16x4(ob + e4 * 4,
                   make_float4(a[j].x * r, a[j].y * r, a[j].z * r,
                               a[j].w * r));
    }
  }
}

// Launches one instantiation. The dynamic shared memory opt-in (above 48
// KB) is set once per device; static, so each instantiation keeps its own
// record of it.
template <int DH, bool L1>
int launch_group(const bf16* q, const bf16* kc, const bf16* vc, bf16* out,
                 float* part, int* counters, int B, int S, int Hkv, int G,
                 int L, int chunk, float scale, cudaStream_t stream) {
  constexpr int SMEM = Dense<DH>::BYTES;
  static unsigned opted = 0;                 // one bit per device
  if (SMEM > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(__atomic_load_n(&opted, __ATOMIC_ACQUIRE) >> dev & 1u)) {
      e = cudaFuncSetAttribute(decode_group_kernel<DH, L1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
      if (e != cudaSuccess) return static_cast<int>(e);
      __atomic_fetch_or(&opted, 1u << dev, __ATOMIC_RELEASE);
    }
  }
  const int nc = (L + chunk - 1) / chunk;
  if (nc > DD_MAX_CHUNKS) return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas =
      (long long)B * Hkv * ((G + DD_ROWS - 1) / DD_ROWS) * nc;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  decode_group_kernel<DH, L1><<<(unsigned)ctas, DD_THREADS, SMEM, stream>>>(
      q, kc, vc, out, part, counters, S, Hkv, G, L, chunk, nc,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(DH) as a std::integral_constant for the head widths the kernel
// is built for; other widths are refused.
template <class F>
int with_width(int dh, F&& f) {
  switch (dh) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dynamic shared memory of the instantiation for dh, 0 if none
extern "C" int flash_decode_smem_bytes(int dh) {
  const int bytes = with_width(dh, [](auto dh_c) {
    return Dense<decltype(dh_c)::value>::BYTES;
  });
  return bytes == static_cast<int>(cudaErrorInvalidValue) ? 0 : bytes;
}

// L = min(length, S) >= 1 positions attended, in chunks of `chunk` (the
// last may be shorter); with tiles = ceil(G / 16), chunks = ceil(L /
// chunk) and pairs = B * Hkv * tiles: part holds pairs * chunks * slot
// floats, slot = min(G, 16) * (dh + 2) rounded up to a multiple of 4, and
// counters pairs ints, zero (the kernel leaves them so). Neither is read
// where chunks = 1. l1 != 0: the K / V copies allocate in L1.
extern "C" int flash_decode_bf16(const void* q, const void* kc, const void* vc,
                                 void* out, void* part, void* counters, int B,
                                 int S, int Hkv, int G, int dh, int length,
                                 int chunk, int l1, float scale,
                                 void* stream) {
  const int L = length < S ? length : S;
  if (G < 1 || L < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_width(dh, [&](auto dh_c) {
    constexpr int DH = decltype(dh_c)::value;
    auto go = l1 ? launch_group<DH, true> : launch_group<DH, false>;
    return go(static_cast<const bf16*>(q), static_cast<const bf16*>(kc),
              static_cast<const bf16*>(vc), static_cast<bf16*>(out),
              static_cast<float*>(part), static_cast<int*>(counters), B, S,
              Hkv, G, L, chunk, scale, static_cast<cudaStream_t>(stream));
  });
}

REPRO_EXPORT_ERROR_STRING
