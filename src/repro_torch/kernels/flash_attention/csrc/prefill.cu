// Causal / sliding-window GQA flash attention over a whole prompt, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_prefill
// (_prefill_kernel), reached through flash_attention/ops.py::attention.
//
// Computes o (B, S, Hq, dh) = softmax(mask(q k^T * scale)) v for bf16
// q (B, S, Hq, dh) and k / v (B, S, Hkv, dh), q head h reading kv head
// h / (Hq / Hkv). Query i attends key j where j <= i (causal) and
// i - j < window (window > 0). All four tensors are read and written
// through TMA tensor maps built from their (batch, position, head) strides;
// head_dim is contiguous. Any S >= 1: the Pallas kernel asserts
// S % 128 == 0, here the maps' position extent is S itself, so TMA fills
// the rows past S with zeros on a load, drops them on a store, and nothing
// past S is ever read or written.
//
// Bound: tensor-core operations. 4 * B * Hq * dh * pairs flops, pairs =
// sum_i min(i + 1, W) (W = S without a window), against 2 * B * S *
// (2 Hq + 2 Hkv) * dh bytes: at the 7B widths (B 8, S 2048, 32 heads,
// dh 128, causal) 2.75e11 flops and 537 MB, 0.278 ms at 989 TFLOP/s; at
// RecurrentGemma's (B 4, S 3000, 16 q heads on 1 kv head, dh 256, window
// 2048) 2.65e11 flops and 209 MB, 0.268 ms.
//
// Design: FlashAttention-3's warp-specialised shape. A CTA of 384 threads
// per (batch, q head, pair of 128-row q tiles): two consumer warpgroups of
// 64 q rows each, then a producer warpgroup of which one thread issues
// every load. Registers are allocated a warpgroup at a time (168 a thread
// at entry); setmaxnreg hands the producer's down to 24 and raises the
// consumers' to 240.
//  * Producer: the Q tile by one TMA load, then the K and V tiles of its
//    band [lo, hi) -- the Pallas kernel's bounds (causal: keys up to the
//    tile's last row; window: from its first row's window start) -- into a
//    2-stage ring. K and V each have a full mbarrier (TMA bytes) and an
//    empty one (the 8 consumer warps) per stage, so a K slot refills as
//    soon as its q k^T is done.
//  * Consumers: s = q k^T by wgmma.m64nBNk16, both operands in shared
//    memory, K-major; scaled in f32; the causal / window / S mask only on
//    tiles that cross an edge; the online softmax in registers (the wgmma
//    accumulator gives each thread rows g and g + 8 of its warp's 16, as
//    mma.sync does, so the quad shuffles carry over); p rounded to bf16 is
//    the register A operand of o += p v, v read MN-major (the transpose
//    bit). Tile t's q k^T and tile t - 1's p v are in flight together, and
//    t's softmax runs under t - 1's p v; o is rescaled only where a row's
//    maximum moved.
//  * Two q tiles per CTA at dh <= 128, each with its own Q buffer: the
//    heavy causal tile n_qt - 1 - x, then its light mirror x, so every CTA
//    walks n_qt + 1 key tiles and the second tile's loads run under the
//    first one's tail. One q tile, heaviest first, at dh 256.
//  * Epilogue: o is staged in the warpgroup's own rows of its Q buffer
//    (swizzled as the O map's box) and written by one TMA store per panel.
//  * BN = 128 keys per tile at dh <= 128, 64 at dh 256 (o takes 128 f32
//    registers per consumer thread there). Shared memory: 2 x 32 KB of Q +
//    a 128 KB K/V ring at dh 128; 64 KB + 128 KB at dh 256.
// Measured on the H100 and left out: ping-pong turns between the two
// consumer warpgroups (no gain over the overlap above), and running the
// causal diagonal tile at half width for warpgroup 0 (the branch makes
// ptxas serialise every wgmma). Not tried yet: a persistent grid, packing
// the G q heads of one kv head into one CTA, TMA multicast across a
// cluster.
//
// Where it can go wrong, and what guards it:
//  * The swizzle of a TMA box and of the wgmma descriptor that reads it
//    must agree (128-byte rows of 64 elements; 64-byte rows at dh 32), and
//    so must the epilogue's staging. A mismatch gives finite, wrong
//    numbers: the card tests and chip_smoke.py hold the kernel to its
//    plain version row by row, at every dh.
//  * A wrong mbarrier phase hangs the CTA. No timeout guards the waits: a
//    trap on that path makes ptxas ignore setmaxnreg (spills at dh 128 and
//    256); run new work under a timeout.
//  * setmaxnreg.inc blocks until the registers the producer released are
//    free: the launch refuses a build whose entry register count cannot
//    cover the consumers' increase.
//  * ptxas serialises the wgmmas (warning C7512 / C7520 in the build
//    report) when it loses track of setmaxnreg (a trap did that) or a
//    wgmma sits on a branch it cannot prove uniform. chip_smoke.py fails
//    on either warning; tools/prefill_variants.py shows what they cost.
//  * No atomics and no split along keys: two calls agree bit for bit.
//
// Two numerical choices: scores are scaled in f32 AFTER the bf16 product,
// as JAX's _gqa_scores does (the Pallas kernel scales q in f32 first, which
// bf16 tensor-core inputs cannot mirror); p is rounded to bf16 before the
// p v product, as both JAX versions do, while l sums the f32 p.
#include "hopper.cuh"
#include "tensor_map.cuh"

using namespace repro;

namespace {

constexpr int BM = 128;                  // q rows per CTA
constexpr int CONSUMER_WARPS = 8;        // two warpgroups of 64 rows
constexpr int THREADS = CONSUMER_WARPS * 32 + 128;   // + the producer's
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Tile {
  static constexpr int BN = DH == 256 ? 64 : 128;     // keys per tile
  static constexpr int PW = DH < 64 ? DH : 64;        // elements per panel row
  static constexpr int SW = PW * 2;                   // swizzle bytes
  static constexpr int NP = DH / PW;                  // panels per row
  // q tiles per CTA, each with a Q buffer of its own: a heavy causal tile
  // and its light mirror (equal work in every CTA), the second one's loads
  // under the first one's tail; one at dh 256, where two do not fit
  static constexpr int ITEMS = DH == 256 ? 1 : 2;
  static constexpr int Q_BYTES = BM * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;        // K or V, one stage
  static constexpr int SMEM =
      1024 + ITEMS * Q_BYTES + 2 * STAGES * KV_BYTES + 128;
};

struct Args {
  int S, G, causal, window;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
prefill_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, const Args p) {
  using T = Tile<DH>;
  constexpr int BN = T::BN, SW = T::SW, PW = T::PW;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned tiles: the swizzle pattern follows address bits
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base + T::ITEMS * T::Q_BYTES;      // [STAGES] tiles
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;        // [STAGES] tiles
  auto q_s = [&](int j) { return base + j * T::Q_BYTES; };
  // mbarriers: per stage K full, V full, K empty, V empty; then each q
  // tile's Q full
  const uint32_t bars = v_s + STAGES * T::KV_BYTES;
  enum { K_FULL, V_FULL, K_EMPTY, V_EMPTY };
  auto bar = [&](int kind, int s) { return bars + 8 * (kind * STAGES + s); };
  auto q_full = [&](int j) { return bars + 8 * (4 * STAGES + j); };

  const int S = p.S;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this CTA's q tiles: n_qt - 1 - x, then x if that is another one
  const int n_qt = (S + BM - 1) / BM, x = blockIdx.x;
  const int items = (T::ITEMS == 2 && x < n_qt - 1 - x) ? 2 : 1;
  auto q0_of = [&](int j) { return (j == 0 ? n_qt - 1 - x : x) * BM; };
  // the band of keys any row of q tile j attends: tiles [t_lo, t_hi)
  auto t_lo_of = [&](int j) {
    return (p.window ? max(q0_of(j) - p.window + 1, 0) : 0) / BN;
  };
  auto t_hi_of = [&](int j) {
    return ((p.causal ? min(q0_of(j) + BM, S) : S) + BN - 1) / BN;
  };
  // the n-th K/V tile the CTA walks lies in stage n % STAGES, in that
  // stage's use number n / STAGES, whose parity its barrier waits take
  auto stage = [](int n) { return n % STAGES; };
  auto parity = [](int n) { return unsigned(n / STAGES) & 1; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(K_FULL, s), 1);
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), CONSUMER_WARPS);
      mbar_init(bar(V_EMPTY, s), CONSUMER_WARPS);
    }
    for (int j = 0; j < T::ITEMS; ++j) mbar_init(q_full(j), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&to);
      int n = 0;
      for (int j = 0; j < items; ++j) {
        mbar_expect_tx(q_full(j), T::Q_BYTES);
        for (int c = 0; c < T::NP; ++c)
          tma_load_4d(q_s(j) + c * BM * SW, &tq, q_full(j), c * PW, h,
                      q0_of(j), b);
        for (int t = t_lo_of(j); t < t_hi_of(j); ++t, ++n) {
          const int s = stage(n);
          const uint32_t off = s * T::KV_BYTES;
          mbar_wait(bar(K_EMPTY, s), parity(n) ^ 1);
          mbar_expect_tx(bar(K_FULL, s), T::KV_BYTES);
          for (int c = 0; c < T::NP; ++c)
            tma_load_4d(k_s + off + c * BN * SW, &tk, bar(K_FULL, s), c * PW,
                        hk, t * BN, b);
          mbar_wait(bar(V_EMPTY, s), parity(n) ^ 1);
          mbar_expect_tx(bar(V_FULL, s), T::KV_BYTES);
          for (int c = 0; c < T::NP; ++c)
            tma_load_4d(v_s + off + c * BN * SW, &tv, bar(V_FULL, s), c * PW,
                        hk, t * BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
    const int wrow = (warp & 3) * 16 + g;        // row g of the warp's 16
    const float sl2 = p.scale * LOG2E;
    // both layouts here step 8 rows of SW bytes between core-matrix groups
    constexpr uint32_t HI = desc_hi(8 * SW, SW);
    auto release = [&](int kind, int n) {
      if (lane == 0) mbar_arrive(bar(kind, stage(n)));
    };

    float o[DH / 2];
    float m[2], l[2];
    float sc[BN / 2];            // scores, then p, of the newest tile
    unsigned pa[BN / 16][4];     // p of the tile in the p v product
    float alpha[2];
    int r0, row[2];              // the warpgroup's first row; this thread's
    uint32_t q_lo;               // the warpgroup's rows of the Q tile

    // s = q k^T for the warpgroup's 64 rows x BN keys of the CTA's n-th
    // K/V tile, issued; k-step kk is 32 bytes into a 128- (or 64-) byte
    // panel row
    auto issue_qk = [&](int n) {
      mbar_wait(bar(K_FULL, stage(n)), parity(n));
      const uint32_t qd = opaque(q_lo);
      const uint32_t kd = desc_lo(k_s + stage(n) * T::KV_BYTES, 16);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk / (PW / 16), off = (kk % (PW / 16)) * 32;
        wgmma_ss<BN>(sc, make_desc(qd + ((c * BM * SW + off) >> 4), HI),
                     make_desc(kd + ((c * BN * SW + off) >> 4), HI), kk);
      }
      wgmma_commit();
    };
    // o += p v, issued: p's A fragments from pa, v read MN-major
    auto issue_pv = [&](int n) {
      mbar_wait(bar(V_FULL, stage(n)), parity(n));
      const uint32_t vd = desc_lo(v_s + stage(n) * T::KV_BYTES, BN * SW);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb<DH>(o, pa[kk],
                        make_desc(vd + ((kk * 16 * SW) >> 4), HI), 1);
      wgmma_commit();
    };
    // the online softmax of key tile t's scores in sc, rows g (e = 0, 1)
    // and g + 8 (e = 2, 3); the four threads of a quad share a row. Scores
    // are scaled in f32 here; m is kept unscaled (scale > 0, so
    // max(s * scale) = max(s) * scale). Leaves p in sc and the factor o
    // takes in alpha.
    auto softmax = [&](int t) {
      const int k0 = t * BN;
      // mask only the tiles that cross the diagonal, window or S
      if ((p.causal && k0 + BN - 1 > r0) ||
          (p.window && r0 + 63 - k0 >= p.window) || k0 + BN > S) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row[e >> 1], c = k0 + j * 8 + tig * 2 + (e & 1);
            if (c >= S || (p.causal && c > r) ||
                (p.window && r - c >= p.window))
              sc[4 * j + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[hr] = (m[hr] == -INFINITY) ? 0.f : ex2((m[hr] - m_use) * sl2);
        m[hr] = m_new;
        const float neg = -m_use * sl2;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const float pe = ex2(fmaf(sc[4 * j + e], sl2, neg));
            sc[4 * j + e] = pe;
            sum += pe;
          }
        l[hr] = l[hr] * alpha[hr] + sum;
      }
    };
    // p rounded to bf16: the score accumulators are p's A fragments in
    // mma.sync's layout
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto pv_done = [&]() {
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
    };

    int n = 0;                   // the CTA's K/V tiles walked so far
    for (int j = 0; j < items; ++j) {
      const int t_lo = t_lo_of(j), t_hi = t_hi_of(j);
      r0 = q0_of(j) + wg * 64;
      row[0] = r0 + wrow;
      row[1] = r0 + wrow + 8;
      q_lo = desc_lo(q_s(j) + wg * 64 * SW, 16);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      // Both warpgroups walk the whole band; a tile that none of a
      // warpgroup's rows attends is masked whole and adds exact zeros.
      mbar_wait(q_full(j), 0);
      issue_qk(n);
      wgmma_wait<0>();
      fence_regs(sc);
      release(K_EMPTY, n);
      softmax(t_lo);                       // o is 0: alpha is not needed
      pack();
      // steady state: key tile t's q k^T and tile t - 1's p v are in
      // flight together, and t's softmax runs under t - 1's p v
      for (int t = t_lo + 1; t < t_hi; ++t) {
        ++n;
        issue_qk(n);
        issue_pv(n - 1);
        wgmma_wait<1>();                   // q k^T, the older group
        fence_regs(sc);
        release(K_EMPTY, n);
        softmax(t);
        wgmma_wait<0>();                   // p v
        pv_done();
        release(V_EMPTY, n - 1);
        // o * 1 is o: skip the rescale where no row of the warp moved its
        // maximum
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < DH / 8; ++i) {
            o[4 * i] *= alpha[0];
            o[4 * i + 1] *= alpha[0];
            o[4 * i + 2] *= alpha[1];
            o[4 * i + 3] *= alpha[1];
          }
        }
        pack();
      }
      issue_pv(n);
      wgmma_wait<0>();
      pv_done();
      release(V_EMPTY, n);
      ++n;

      // normalise; stage the warpgroup's 64 x DH tile in its own rows of
      // the Q tile (no longer read), swizzled as the O map's box, and store
      // it with TMA, which drops the rows past S. 16-byte chunk c of row r
      // lies at chunk c ^ (r % 8) (128-byte rows) or c ^ (r / 2 % 4)
      // (64-byte rows).
      const uint32_t o_s = q_s(j) + wg * 64 * SW;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float lt = l[hr];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.f / fmaxf(lt, 1e-30f);
        const int r = wrow + 8 * hr;
        const int swz = SW == 128 ? (r & 7) : ((r >> 1) & 3);
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          const int c = i / (PW / 8), chunk = i % (PW / 8);
          st_shared_u32(o_s + c * BM * SW + r * SW + ((chunk ^ swz) << 4) +
                            tig * 4,
                        pack_bf16(o[4 * i + 2 * hr] * inv,
                                  o[4 * i + 2 * hr + 1] * inv));
        }
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if ((threadIdx.x & 127) == 0) {
        for (int c = 0; c < T::NP; ++c)
          tma_store_4d(&to, o_s + c * BM * SW, c * PW, h, r0, b);
        tma_store_commit();
      }
    }
    if ((threadIdx.x & 127) == 0) tma_store_wait();
  }
}

// A (B, S, H, dh) bf16 tensor as the 4-D map (dh, H, S, B), strides in
// elements; boxes of (pw, 1, rows, 1), swizzled to pw * 2 bytes. The
// position extent is the logical S: rows past it load as zeros.
bool encode(CUtensorMap* map, const void* ptr, int dh, int H, int S, int B,
            long long sh, long long ss, long long sb, int pw, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)pw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            pw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const Args& a, int B, int Hq, int Hkv, const long long (&st)[12],
           cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap tq, tk, tv, to;
  if (!encode(&tq, q, DH, Hq, a.S, B, st[2], st[1], st[0], T::PW, BM) ||
      !encode(&tk, k, DH, Hkv, a.S, B, st[5], st[4], st[3], T::PW, T::BN) ||
      !encode(&tv, v, DH, Hkv, a.S, B, st[8], st[7], st[6], T::PW, T::BN) ||
      !encode(&to, o, DH, Hq, a.S, B, st[11], st[10], st[9], T::PW, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // setmaxnreg.inc waits for the registers the producer warpgroup gives
  // back: refuse a build whose entry count would leave the consumers
  // waiting
  static const int regs = [] {
    cudaFuncAttributes fa;
    return cudaFuncGetAttributes(&fa, prefill_kernel<DH>) == cudaSuccess
               ? fa.numRegs : 0;
  }();
  if ((regs - PRODUCER_REGS) * 128 < (CONSUMER_REGS - regs) * 32 * CONSUMER_WARPS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // above 48 KB of dynamic shared memory only after this opt-in (set on
  // every launch: it is per device and costs no device time)
  const cudaError_t e = cudaFuncSetAttribute(
      prefill_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (a.S + BM - 1) / BM;
  const dim3 grid((n_qt + T::ITEMS - 1) / T::ITEMS, Hq, B);
  prefill_kernel<DH><<<grid, THREADS, T::SMEM, stream>>>(tq, tk, tv, to, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Hq, int Hkv, int dh, int causal, int window, int sqb, int sqs,
    int sqh, int skb, int sks, int skh, int svb, int svs, int svh, int sob,
    int sos, int soh, float scale, void* stream) {
  if (S < 1 || Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{S, Hq / Hkv, causal, window, scale};
  const long long st[12] = {sqb, sqs, sqh, skb, sks, skh,
                            svb, svs, svh, sob, sos, soh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(q, k, v, o, a, B, Hq, Hkv, st, s);
    case 64: return launch<64>(q, k, v, o, a, B, Hq, Hkv, st, s);
    case 128: return launch<128>(q, k, v, o, a, B, Hq, Hkv, st, s);
    case 256: return launch<256>(q, k, v, o, a, B, Hq, Hkv, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the dynamic shared memory one CTA takes at head_dim dh (0 for another)
extern "C" int flash_prefill_smem_bytes(int dh) {
  switch (dh) {
    case 32: return Tile<32>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 128: return Tile<128>::SMEM;
    case 256: return Tile<256>::SMEM;
    default: return 0;
  }
}

REPRO_EXPORT_ERROR_STRING
