// The wgmma product core of the Monarch kernels (monarch.cu, monarch_conv.cu)
// for Hopper (sm_90a).
//
// One CTA per (batch row b, block of BM rows of N1) runs the products that
// are local to its block, back to back, with every intermediate kept in
// shared memory:
//
//   phase 1  A_blk^T (N2 x BM) = x[b]^T . W0[blk]^T, times tw[blk]^T,
//            rounded to bf16                              (both kernels)
//   phase 2  W1 . A_blk^T (N2 x BM): Z[b][:, blk] (the pass), or
//            F_blk = bf16(bf16(.) * filt[:, blk])          (the conv)
//   phase 3  Bm[b][:, blk] = bf16((W0i . F_blk) * twi[:, blk])  (the conv)
//
// Every product is wgmma.m64nBMk16 with f32 accumulators: its M runs over
// N2 (64 rows a warpgroup, two consumer warpgroups, so 128-row chunk
// pairs), its N is the block's BM rows, its K is N1 (phase 1) or N2. The
// transpose of the Pallas kernel is an access pattern throughout:
//  * Phase 1 reads x[b] as wgmma's A operand MN-major (the transpose bit:
//    x's rows are k, its columns the product's M) and W0[blk] as B,
//    K-major. Its epilogue multiplies the twiddle and writes A_blk
//    K-major, [BM][N2] in 64-column panels of 128-byte rows with the
//    128-byte swizzle, by stmatrix.trans from the accumulators.
//  * Phase 2 reads W1 (A, K-major) and A_blk (B, K-major, resident). The
//    conv's epilogue writes F_blk^T in the same panel layout for phase 3,
//    which reads W0i (A) and F_blk^T (B) the same way.
// No intermediate reaches device memory but the one the conv's second
// launch reads (monarch_conv.cu: F or Bm).
//
// The streams. Two producer threads (their warpgroup gives its registers
// to the two consumer warpgroups, setmaxnreg) feed mbarrier-guarded TMA
// tiles (full: the bytes landed; empty: the readers are done):
//  * one thread, the A ring: `stages` tiles of 128 rows x 64 k (16 KB),
//    x[b] in phase 1, then W1 (and W0i) by chunk pair and k-step;
//  * the other, the CTA's own tiles: the B ring (two W0[blk] k-tiles of BM
//    x 64, each read by every chunk of its k-step); the twiddle ring (two
//    slots, one a phase-1 slab, whose rows TMA lands in the very A_blk
//    panels the slab's epilogue overwrites: each warp reads its own 16
//    columns' twiddles, then stores over them, so they take no shared
//    memory of their own); the conv's epilogue slot (the filter or inverse
//    twiddle tile of a phase-2 / phase-3 chunk pair, 128 x BM unswizzled,
//    loaded as soon as the pair before is done with it). The conv's
//    forward pass (a pass with the filter in phase 2's epilogue) puts its
//    filter tiles where the B ring was, once phase 1 is done with it.
// A tile that wgmma reads is released once a warpgroup's group of wgmmas
// is done (wait 0, not 1: the two warpgroups keep the tensor cores busy
// between them, and a stage held one group longer leaves the ring a stage
// short); a tile every thread reads, once each warp.
// Phase 1 covers N2 in slabs of `chunks` chunk pairs (accumulators for all
// of them, 128 f32 registers a thread at most): W0[blk] is read once per
// slab, once in all at the shapes that matter.
//
// What bounds it on an H100 (PERF.md): the operand stream into each SM. A
// product at N = BM reuses each streamed byte BM times, so the tensor
// cores want ~112 GB/s an SM at BM 64 (twice that at 32), more than a ring
// of this shape takes in from L2 with nothing computed
// (tools/l2_stream_bench.cu); and wgmma's shared-memory reads at N = BM
// (each 64-row product reads its A tile and the resident B again) nearly
// fill the SM's shared-memory bandwidth. Neighbouring blocks read the same
// x[b], W1 and W0i, but sharing those tiles across a thread-block cluster
// by TMA multicast halved the L2 reads and made no launch faster, so every
// CTA loads its own.
//
// ops.py::monarch_plan picks BM, the stage count and the slab per shape
// (the kernel receives them and checks them against smem_bytes): shared
// memory holds the resident intermediates (BM x N2 each), the rings and
// the barriers.
//
// Where it can go wrong, and what guards it: a wrong mbarrier phase hangs
// the CTA (run new work under a timeout); the TMA boxes' 128-byte swizzle
// must match the wgmma descriptors and the epilogue's stmatrix addresses
// (finite, wrong numbers otherwise: the card tests hold both kernels to
// their plain versions at every (BM, slab) the plan picks); a loop over
// the phases that carries the accumulators makes ptxas serialise the
// wgmmas (C7515), so it is unrolled, and chip_smoke.py fails on that
// warning and on a spill. Each call initialises its barriers anew, and no
// atomics touch values: two calls agree bit for bit.
#pragma once

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace repro {
namespace monarch {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 128;    // + the producer warpgroup
// registers a thread: the producer's warpgroup hands its own down to the
// consumers (setmaxnreg), whose accumulators take up to 128
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int KD = 64;                      // k depth of a tile: 128-byte rows
constexpr int MC = 128;                     // rows of a chunk pair
constexpr int HALF = 64 * KD * 2;           // one warpgroup's 64 rows
constexpr int A_STAGE = 2 * HALF;           // one A tile (16 KB)
constexpr int SLOTS = 2;                    // B and twiddle ring slots
constexpr int MAX_STAGES = 8;
// full and empty barriers: the A ring's, the B ring's, the twiddle ring's,
// the conv's epilogue slot's
constexpr int BAR_BYTES = 8 * 2 * (MAX_STAGES + 2 * SLOTS + 1);
constexpr uint32_t HI = desc_hi(8 * 128, 128);   // 8-row groups of 128 B

// The slab's chunk pairs where the accumulators cover more than one: 128
// f32 registers a consumer thread
__host__ __device__ constexpr int max_chunks(int bm) {
  return bm >= 64 ? 4 : 8;
}

// Dynamic shared memory of a pass (conv false) or conv front kernel, in
// bytes: alignment slack, the resident A_blk (and F_blk^T), the A ring,
// the B ring, the conv's epilogue slot, the barriers. ops.py::monarch_smem
// is the same sum.
__host__ __device__ constexpr int smem_bytes(int bm, int stages, int n2,
                                             bool conv) {
  return 1024 + bm * n2 * 2 * (conv ? 2 : 1) + stages * A_STAGE +
         SLOTS * bm * KD * 2 + (conv ? MC * bm * 2 : 0) + BAR_BYTES;
}

// The largest opt-in dynamic shared memory a block may have on this device
inline int smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

// A plan (ops.py::monarch_plan) the kernels take: BM 64 / 32 / 16 (the
// conv 32 / 16), 2..MAX_STAGES stages, a slab of 1 or max_chunks(BM) chunk
// pairs dividing N2 / 128, its shared memory within the device's limit.
inline bool plan_ok(int N1, int N2, int bm, int stages, int chunks,
                    bool conv) {
  if (!(bm == 32 || bm == 16 || (bm == 64 && !conv))) return false;
  if (N1 < 64 || N1 % 64 || N2 < MC || N2 % MC) return false;
  if (stages < 2 || stages > MAX_STAGES) return false;
  if (!(chunks == 1 || chunks == max_chunks(bm)) || (N2 / MC) % chunks)
    return false;
  return smem_bytes(bm, stages, N2, conv) <= smem_limit();
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// a ring position: slot and the parity of its current use
struct Pos {
  int s = 0;
  unsigned p = 0;
  __device__ void next(int n) {
    if (++s == n) {
      s = 0;
      p ^= 1;
    }
  }
};

// The tensor maps of the front kernels. x (B N1, N2) in boxes of 64 x 64;
// W0 (N1, N1) and tw (N1, N2) in boxes of 64 x BM; W1 and W0i (N2, N2) in
// boxes of 64 x 128; filt and twi (N2, N1) unswizzled in boxes of BM x
// 128.
struct Maps {
  CUtensorMap x, w0, tw, w1, filt, w0i, twi;
};

// Phase 1's epilogue for one chunk: the accumulators (rows: the chunk's 64
// values of n, 16 a warp; columns: the block's BM rows j) times the twiddle
// tw[r0 + j][n], which TMA landed in the chunk's A_blk panel at (j, n),
// rounded to bf16 and stored over it, transposed. `panel` is the panel's
// shared-memory address, `gpanel` the same as a generic pointer.
template <int BN>
__device__ __forceinline__ void twiddle_store(const float (&acc)[BN / 2],
                                              uint32_t panel,
                                              const unsigned char* gpanel) {
  const int lane = threadIdx.x & 31, wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
  float v[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * i + 2 * tig + e;
        const bf16 t = *reinterpret_cast<const bf16*>(
            gpanel + j * 128 + (((2 * wi + h) ^ (j & 7)) << 4) + g * 2);
        v[4 * i + 2 * h + e] = acc[4 * i + 2 * h + e] * __bfloat162float(t);
      }
  __syncwarp();
  const int q = lane >> 3, t = lane & 7;
#pragma unroll
  for (int i = 0; i < BN / 8; i += 2) {
    const int j = 8 * (i + (q >> 1)) + t;
    stmatrix_x4_trans(panel + j * 128 + (((2 * wi + (q & 1)) ^ t) << 4),
                      pack_bf16(v[4 * i], v[4 * i + 1]),
                      pack_bf16(v[4 * i + 2], v[4 * i + 3]),
                      pack_bf16(v[4 * i + 4], v[4 * i + 5]),
                      pack_bf16(v[4 * i + 6], v[4 * i + 7]));
  }
}

// The conv's phase-2 epilogue for one chunk: F = bf16(bf16(acc) * filt)
// (filt's tile `mult`, [128][BN], this warpgroup's rows at `row0`), stored
// transposed into F_blk^T's panel.
template <int BN>
__device__ __forceinline__ void filter_store(const float (&acc)[BN / 2],
                                             const bf16* mult, int row0,
                                             uint32_t panel) {
  const int lane = threadIdx.x & 31, wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
  unsigned f[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(
          mult + (row0 + 16 * wi + g + 8 * h) * BN + 8 * i + 2 * tig);
      f[2 * i + h] = pack_bf16(
          round_bf16(acc[4 * i + 2 * h]) * __low2float(m),
          round_bf16(acc[4 * i + 2 * h + 1]) * __high2float(m));
    }
  const int q = lane >> 3, t = lane & 7;
#pragma unroll
  for (int i = 0; i < BN / 8; i += 2) {
    const int j = 8 * (i + (q >> 1)) + t;
    stmatrix_x4_trans(panel + j * 128 + (((2 * wi + (q & 1)) ^ t) << 4),
                      f[2 * i], f[2 * i + 1], f[2 * i + 2], f[2 * i + 3]);
  }
}

// out[m][c0 + j] for the warpgroup's 64 rows from m0, row stride ld:
// bf16(acc), or with `mult` ([128][BN] at row0) bf16(acc * mult), or with
// `round` too bf16(bf16(acc) * mult)
template <int BN>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2],
                                           bf16* out, long long ld, int m0,
                                           int c0, const bf16* mult,
                                           int row0, bool round = false) {
  const int lane = threadIdx.x & 31, wi = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wi + g + 8 * h, c = 8 * i + 2 * tig;
      float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (round) {
        v0 = round_bf16(v0);
        v1 = round_bf16(v1);
      }
      if (mult != nullptr) {
        const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(
            mult + (row0 + r) * BN + c);
        v0 *= __low2float(m);
        v1 *= __high2float(m);
      }
      *reinterpret_cast<unsigned*>(out + (m0 + r) * ld + c0 + c) =
          pack_bf16(v0, v1);
    }
}

// The front kernel's body: the pass (CONV false: phases 1-2, out = Z (B,
// N2, N1); with `filtered`, Z = bf16(bf16(Z) * filt), the conv's forward
// pass) or the conv's one-front launch (phases 1-3, out = Bm (B, N2, N1)).
// Grid (N1 / BM, B), THREADS threads, smem_bytes(BM, S, N2, CONV) of
// dynamic shared memory. R: the slab's chunk pairs.
template <bool CONV, int BM, int R>
__device__ __forceinline__ void front(const Maps& mp, bf16* __restrict__ out,
                                      int N1, int N2, int S,
                                      bool filtered = false) {
  constexpr int BN = BM;
  constexpr int PANEL = BM * KD * 2;       // a 64-column panel of BM rows
  constexpr int EPI = MC * BM * 2;         // one epilogue slot (conv)
  static_assert(R * BN / 2 <= 128, "accumulators");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // 1024-byte aligned tiles: the swizzle pattern follows address bits
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t as = base;                          // A_blk, [N2/64][BM][64]
  const uint32_t fs = as + BM * N2 * 2;              // F_blk^T (conv)
  const uint32_t ring = fs + (CONV ? BM * N2 * 2 : 0);
  const uint32_t bring = ring + S * A_STAGE;
  const uint32_t epi = bring + SLOTS * PANEL;
  const uint32_t bars = epi + (CONV ? EPI : 0);
  auto full_a = [&](int s) { return bars + 8 * s; };
  auto empty_a = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  auto full_b = [&](int s) { return bars + 8 * (2 * MAX_STAGES + s); };
  auto empty_b = [&](int s) { return bars + 8 * (2 * MAX_STAGES + 2 + s); };
  auto full_t = [&](int s) { return bars + 8 * (2 * MAX_STAGES + 4 + s); };
  auto empty_t = [&](int s) { return bars + 8 * (2 * MAX_STAGES + 6 + s); };
  const uint32_t full_e = bars + 8 * (2 * MAX_STAGES + 8);
  const uint32_t empty_e = full_e + 8;

  const int r0 = blockIdx.x * BM, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NP = N2 / MC, KT1 = N1 / KD, KT2 = N2 / KD;

  if (threadIdx.x == 0) {
    // a tile read by wgmma is released once a warpgroup (its completion is
    // the warpgroup's); a tile read by every consumer thread, once each warp
    for (int s = 0; s < S; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), 2);
    }
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), 2);
      mbar_init(full_t(s), 1);
      mbar_init(empty_t(s), CONSUMERS / 32);
    }
    mbar_init(full_e, 1);
    mbar_init(empty_e, CONSUMERS / 32);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      // the A ring: x[b] by (slab, k-step, chunk pair), then W1 (and W0i)
      // by (chunk pair, k-step)
      tma_prefetch_map(&mp.x);
      tma_prefetch_map(&mp.w1);
      if (CONV) tma_prefetch_map(&mp.w0i);
      Pos a;
      // the next A stage, once free, expecting the whole tile
      auto a_stage = [&]() {
        mbar_wait(empty_a(a.s), a.p ^ 1);
        mbar_expect_tx(full_a(a.s), A_STAGE);
        return ring + a.s * A_STAGE;
      };
      // (the loops stay rolled: the producer keeps PRODUCER_REGS)
#pragma unroll 1
      for (int slab = 0; slab < NP / R; ++slab)
#pragma unroll 1
        for (int kt = 0; kt < KT1; ++kt)
#pragma unroll 1
          for (int r = 0; r < R; ++r) {
            const uint32_t st = a_stage();
            const int n0 = (slab * R + r) * MC;
            for (int w = 0; w < 2; ++w)
              tma_load_2d(st + w * HALF, &mp.x, full_a(a.s), n0 + 64 * w,
                          b * N1 + kt * KD);
            a.next(S);
          }
#pragma unroll 1
      for (int ph = 0; ph < (CONV ? 2 : 1); ++ph)
#pragma unroll 1
        for (int p = 0; p < NP; ++p)
#pragma unroll 1
          for (int kt = 0; kt < KT2; ++kt) {
            const uint32_t st = a_stage();
            tma_load_2d(st, ph == 0 ? &mp.w1 : &mp.w0i, full_a(a.s), kt * KD,
                        p * MC);
            a.next(S);
          }
    } else if (warp == CONSUMERS / 32 + 1 && lane == 0) {
      // the CTA's own tiles, from a thread of their own so that the A ring
      // never waits behind them: per slab its twiddle rows (into the panels
      // its epilogue overwrites), per k-step the W0[blk] tile; in the conv,
      // per chunk pair its filter (phase 2) or inverse twiddle (phase 3)
      // tile into the one epilogue slot, once the last pair is done with it
      tma_prefetch_map(&mp.w0);
      tma_prefetch_map(&mp.tw);
      if (CONV) {
        tma_prefetch_map(&mp.filt);
        tma_prefetch_map(&mp.twi);
      }
      Pos bb, t;
#pragma unroll 1
      for (int slab = 0; slab < NP / R; ++slab) {
        mbar_wait(empty_t(t.s), t.p ^ 1);
        mbar_expect_tx(full_t(t.s), 2 * R * PANEL);
#pragma unroll 1
        for (int q = 0; q < 2 * R; ++q) {
          const int panel = 2 * R * slab + q;
          tma_load_2d(as + panel * PANEL, &mp.tw, full_t(t.s), panel * KD,
                      r0);
        }
        t.next(SLOTS);
#pragma unroll 1
        for (int kt = 0; kt < KT1; ++kt) {
          mbar_wait(empty_b(bb.s), bb.p ^ 1);
          mbar_expect_tx(full_b(bb.s), PANEL);
          tma_load_2d(bring + bb.s * PANEL, &mp.w0, full_b(bb.s), kt * KD, r0);
          bb.next(SLOTS);
        }
      }
      if (!CONV && filtered) {
        // the filter tiles go where the B ring was: wait until its last
        // two tiles are read
        for (int i = 0; i < SLOTS; ++i) {
          mbar_wait(empty_b(bb.s), bb.p ^ 1);
          bb.next(SLOTS);
        }
      }
      if (CONV || filtered) {
#pragma unroll 1
        for (int ne = 0; ne < (CONV ? 2 : 1) * NP; ++ne) {
          mbar_wait(empty_e, (ne & 1) ^ 1);
          mbar_expect_tx(full_e, EPI);
          tma_load_2d(CONV ? epi : bring, ne < NP ? &mp.filt : &mp.twi,
                      full_e, r0, (ne % NP) * MC);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp >> 2, wi = warp & 3;
    Pos a, bb, t;
    int ne = 0;
    // an A stage or a B slot goes back once a warpgroup, a twiddle or
    // epilogue slot once a warp
    auto release_wg = [&](uint32_t bar) {
      if (wi == 0 && lane == 0) mbar_arrive(bar);
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    float acc[R][BN / 2];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

    // phase 1: each slab's chunks accumulate over the k-steps of N1 in
    // turn. Each group's A stage (and, after its k-step's last chunk, its
    // B slot) is released as soon as the group is done: the two warpgroups
    // keep the tensor cores busy between them, and a stage held one group
    // longer (the next group issued first) leaves the ring a stage short
    for (int slab = 0; slab < NP / R; ++slab) {
      for (int kt = 0; kt < KT1; ++kt) {
        mbar_wait(full_b(bb.s), bb.p);
        const uint32_t bd = desc_lo(bring + bb.s * PANEL, 16);
        const int cur_b = bb.s;
        bb.next(SLOTS);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mbar_wait(full_a(a.s), a.p);
          const uint32_t ad = desc_lo(ring + a.s * A_STAGE + wg * HALF, HALF);
          fence_regs(acc[r]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KD / 16; ++kk)
            wgmma_ss_ta<BN>(acc[r], make_desc(ad + ((kk * 16 * 128) >> 4), HI),
                            make_desc(bd + ((kk * 32) >> 4), HI),
                            kt > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          release_wg(empty_a(a.s));
          if (r == R - 1) release_wg(empty_b(cur_b));
          a.next(S);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) fence_regs(acc[r]);
      mbar_wait(full_t(t.s), t.p);              // the slab's twiddles
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int panel = 2 * (slab * R + r) + wg;
        twiddle_store<BN>(acc[r], as + panel * PANEL,
                          gbase + (as - base) + panel * PANEL);
      }
      release(empty_t(t.s));
      t.next(SLOTS);
    }
    // A_blk complete: written through the generic proxy, read by wgmma
    fence_async_shared();
    named_sync(1, CONSUMERS);

    const long long plane = (long long)N1 * N2;
    // unrolled: a loop carried over the phases would move the accumulators
    // between them, and ptxas then serialises every wgmma
#pragma unroll
    for (int ph = 0; ph < (CONV ? 2 : 1); ++ph) {
      const uint32_t bop = ph == 0 ? as : fs;
      for (int p = 0; p < NP; ++p) {
        for (int kt = 0; kt < KT2; ++kt) {
          mbar_wait(full_a(a.s), a.p);
          const uint32_t ad = desc_lo(ring + a.s * A_STAGE + wg * HALF, 16);
          const uint32_t bd = desc_lo(bop + kt * PANEL, 16);
          fence_regs(acc[0]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KD / 16; ++kk)
            wgmma_ss<BN>(acc[0], make_desc(ad + ((kk * 32) >> 4), HI),
                         make_desc(bd + ((kk * 32) >> 4), HI),
                         kt > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          release_wg(empty_a(a.s));
          a.next(S);
        }
        fence_regs(acc[0]);
        const int m0 = p * MC + wg * 64;
        if (!CONV && !filtered) {
          store_rows<BN>(acc[0], out + b * plane, N1, m0, r0, nullptr, 0);
        } else if (!CONV) {
          mbar_wait(full_e, ne & 1);
          store_rows<BN>(acc[0], out + b * plane, N1, m0, r0,
                         reinterpret_cast<const bf16*>(gbase + (bring - base)),
                         wg * 64, true);
          release(empty_e);
          ++ne;
        } else {
          mbar_wait(full_e, ne & 1);
          const bf16* mult =
              reinterpret_cast<const bf16*>(gbase + (epi - base));
          if (ph == 0)
            filter_store<BN>(acc[0], mult, wg * 64,
                             fs + (2 * p + wg) * PANEL);
          else
            store_rows<BN>(acc[0], out + b * plane, N1, m0, r0, mult,
                           wg * 64);
          release(empty_e);
          ++ne;
        }
      }
      if (CONV && ph == 0) {
        // F_blk^T complete
        fence_async_shared();
        named_sync(1, CONSUMERS);
      }
    }
  }
}

// Launches front kernel k on grid (N1 / BM, B) with smem bytes of dynamic
// shared memory
template <class... Args>
int launch_smem(void (*k)(Args...), dim3 grid, int smem, cudaStream_t s,
                Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, THREADS, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps of one front launch (Maps), or false where the driver
// refused one; filt, w0i and twi may each be null (a map they do not use)
inline bool front_maps(Maps* mp, const void* x, const void* w0,
                       const void* tw, const void* w1, const void* filt,
                       const void* w0i, const void* twi, int B, int N1,
                       int N2, int bm) {
  const uint64_t r1 = uint64_t(N1) * 2, r2 = uint64_t(N2) * 2;
  bool ok = map_2d_bf16(&mp->x, x, N2, uint64_t(B) * N1, r2, 64, KD) &&
            map_2d_bf16(&mp->w0, w0, N1, N1, r1, 64, bm) &&
            map_2d_bf16(&mp->tw, tw, N2, N1, r2, 64, bm) &&
            map_2d_bf16(&mp->w1, w1, N2, N2, r2, 64, MC);
  mp->filt = mp->w0i = mp->twi = mp->w1;
  if (filt != nullptr)
    ok = ok && map_2d_bf16(&mp->filt, filt, N1, N2, r1, bm, MC, false);
  if (w0i != nullptr)
    ok = ok && map_2d_bf16(&mp->w0i, w0i, N2, N2, r2, 64, MC) &&
         map_2d_bf16(&mp->twi, twi, N1, N2, r1, bm, MC, false);
  return ok;
}

}  // namespace monarch
}  // namespace repro
