// The backward of GQA flash attention over a whole prompt (causal,
// sliding-window or full), for Hopper (sm_90a): dq, dk, dv of o =
// softmax(mask(q k^T * scale)) v.
//
// Replaces: no Pallas kernel. JAX's train step differentiates
// models/layers.py::attention (the XLA block_attention, the pure-JAX
// analogue of kernel.py::flash_prefill) and XLA derives its backward; the
// port's forward is the flash_prefill kernel (prefill.cu), whose result
// has no gradient without this. It computes the flash backward of JAX's
// Pallas TPU kernel -- di = rowsum(o * do) once, p recomputed from q, k
// and the forward's row log-sum-exp -- with p formed once for dK, dV and
// dQ together, at every width.
//
// Inputs, all contiguous: q (B, Sq, Hq, dk), o, do (B, Sq, Hq, dv) bf16;
// k (B, Sk, Hkv, dk), v (B, Sk, Hkv, dv) bf16; lse (B, Hq, Sq) f32 from
// the LSE form of prefill.cu. Outputs dq, dk, dv shaped as q, k, v, bf16.
// (dk, dv) = (d, d) for d 32/64/128/256, or (192, 128); any G = Hq / Hkv.
// Query i attends key j where j <= i (causal) and i - j < window (window >
// 0), with Sq = Sk = S >= 1; or, with neither (FULL: Whisper's encoder and
// its cross-attention), every key, for any Sq, Sk >= 1.
//   p = exp(q k^T scale - lse), dv = p^T do, dp = do v^T,
//   ds = p (dp - di), dq = scale ds k, dk = scale ds^T q.
//
// Bound: tensor-core operations. The five products over the attended
// pairs, 2 * B * Hq * pairs * (3 dk + 2 dv) flops (s, dp, dv, dq, dk),
// against the bytes of q, k, v, o, do, lse read once and dq, dk, dv
// written once: at the 7B expert's training shape (B 4, S 2048, 32 heads,
// dh 128, causal) 3.437e11 flops and ~539 MB, 0.3475 ms at 989 TFLOP/s.
// This design issues exactly those five: p is formed once.
//
// Design: prefill.cu's warp-specialised shape. Three launches at d 32 /
// 64 / 128 (at d 256 and (192, 128), wide_kernel takes bwd_kernel's
// place, with a fourth where it splits the heads; see its section):
//  * stat_kernel: one CTA per (64-row q tile, q head, batch): di =
//    rowsum(o * do) in f32 and lse * log2(e), into a scratch of (B, Hq,
//    2, Sp) f32, Sp = Sq rounded up to 128. Rows past Sq get lse * log2(e)
//    = +inf and di = 0, so p = exp2(s * scale * log2(e) - inf) = 0 there:
//    the zero q row that TMA loads past Sq (s = 0) adds nothing, with no
//    mask. It also zeroes the q tile's turn counter (below).
//  * bwd_kernel: one CTA of 384 threads per (128-key tile, kv head,
//    batch): two consumer warpgroups of 64 keys each, then a producer
//    warpgroup, cut to 32 registers by setmaxnreg (the consumers raised to
//    232), in which one thread issues every load and one (of the next
//    warp) writes dQ. K and V are loaded once. The loader walks the G q
//    heads of the kv head and, for each, the 64-row q tiles of the key
//    tile's band (every q tile under FULL; from its first key under
//    causal; up to its last key + window - 1 with a window), streaming Q
//    and dO (TMA boxes of 64-element
//    rows, 128-byte swizzled; 64-byte at d 32) with their 64 lse * log2(e)
//    and di values (one bulk copy each) into a ring with full and empty
//    mbarriers a stage (2 stages at d 128, 4 below). Per q tile, each
//    consumer warpgroup:
//      s^T = K Q^T, dp^T = V dO^T    wgmma m64n64k16, both in shared memory
//      p^T = exp2(s^T scale log2(e) - lse2)   masked only on tiles that
//                                    cross the diagonal or the window edge
//      ds^T = p^T (dp^T - di)
//      dV += p^T dO, dK += ds^T Q    p^T, ds^T rounded to bf16 in registers
//                                    as the A operand; dO, Q read MN-major
//      ds -> shared memory           stmatrix .trans: q rows of the CTA's
//                                    128 keys, K-major, 128-byte swizzled
//      dQ(64 x d/2) = ds K           after both warpgroups stored their ds
//                                    (a named barrier): A the ds tile, B
//                                    the K tile's half of the columns,
//                                    MN-major; K = the CTA's 128 keys
//    The accumulator's rows are keys, so lse2 and di index its columns:
//    each thread reads its 16 columns' values from the stage. dK and dV
//    (64 + 64 f32 registers a thread at d 128) stay in the CTA: it sums
//    the G heads itself, with no atomics. dQ is staged in f32 (two
//    buffers, 128-byte swizzled boxes of 32 columns) for the writer,
//    which adds it into an f32 workspace (B, Hq, Sp, d) by TMA: a store
//    for the first key tile of a q tile, a reduction (cp.reduce.async.bulk
//    .add) for the others, in a fixed order -- the key tiles of a q tile
//    from the last down -- under a turn counter a (batch, q head, q tile):
//    the writer waits until the counter reaches its key tile's place,
//    adds, waits for the writes to complete and increments it. The grid
//    launches a (batch, kv head)'s key tiles together, the last first, so
//    its workspace stays in L2 and a CTA only waits on key tiles launched
//    before it: no deadlock. Under causal key tile kt reaches q tile t two
//    tiles after key tile kt + 1 did, so the turns are rarely waited for.
//    Epilogue: dK scaled and dV staged in the warpgroup's own rows of the
//    K and V buffers once both warpgroups are done, stored by TMA (which
//    drops keys past S).
//  * dq_out_kernel: dq = scale * the workspace, rounded to bf16.
// Deterministic: every dK / dV element is summed by one thread in a fixed
// order and every dQ element in the fixed turn order; two calls agree bit
// for bit. Nothing past S is written.
// Measured on the H100 and left out (PERF.md): two kernels forming p
// twice (dK/dV as above without dQ, then a dQ kernel of 64-key tiles
// under the forward's pairing of q tiles; 7 products), 1.01-1.07 against
// 0.87-0.88 ms at the 7B shape but 2.0 against 2.5 at Mixtral's, whose
// long bands leave this grid a tail; launching a (batch, kv head)'s
// heaviest key tile first removes that tail (1.9-2.0 ms) but makes its
// turns wait on key tiles launched after it, which can deadlock once a
// (batch, kv head) has more key tiles than the card has SMs; writing dq
// from the last contributor's writer warps, or from key tile 0's CTA
// after its walk, in place of dq_out_kernel (1.01 and 1.02 ms: both put
// the rounding on the longest CTAs' path); at d 256 and (192, 128), a
// pair of mma.sync kernels forming p twice (2.29 ms at DeepSeek's MLA
// shape, 4.38 at RecurrentGemma's; wide_kernel replaced them).
//
// Where it can go wrong, and what guards it:
//  * A swizzle, descriptor or fragment mapping that is off gives finite,
//    wrong numbers: the card tests and chip_smoke.py hold dq, dk, dv to
//    ref.py::attention_bwd_ref in f32 (each layer of the training phase at
//    the model's inputs), with a mask and a di fault planted in the
//    reference that the check must catch.
//  * A wrong mbarrier phase, or a turn that never comes, hangs the CTA (no
//    timeout: prefill.cu says why); run new work under a timeout. A q
//    tile's contributors are key tiles t / 2 down to the first under
//    causal, the last down to the first otherwise: every key tile in that
//    range walks the q tile.
//  * ptxas serialises the wgmmas (C7512 / C7520) when one sits on a branch
//    it cannot prove uniform or registers run short: both consumer
//    warpgroups walk the whole band and a tile that none of a warpgroup's
//    pairs attends is masked whole. chip_smoke.py fails on the warning and
//    on a spill.
//  * Rows past Sq load as zeros: lse2 = +inf zeroes their p. Keys past S
//    in a square call only reach dK / dV rows that are not stored (their
//    p sits under the causal mask). Under FULL a zero K row gives s = 0
//    and p = exp(-lse), which need not be small (a row whose scores are
//    all very negative has lse far below 0): dQ would gain p (0 - di) * 0,
//    NaN once p overflows, so FULL masks keys past Sk (a card test at Sk
//    % 128 != 0 and chip_smoke.py's planted unmasked padding key hold it).
#include "hopper.cuh"
#include "tensor_map.cuh"

using namespace repro;

namespace {

constexpr int CONSUMER_WARPS = 8;        // two warpgroups
constexpr int THREADS = CONSUMER_WARPS * 32 + 128;   // + the producer's
constexpr int PRODUCER_REGS = 32;        // the loads and the dQ writer
constexpr int CONSUMER_REGS = 232;
constexpr int BK = 128;                  // keys per CTA, 64 a warpgroup
constexpr int BQ = 64;                   // q rows per ring tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;         // a CTA's opt-in limit, sm_90

// rows of the scratch a (batch, q head) holds: S rounded up to 128
__host__ __device__ constexpr int stat_len(int S) {
  return (S + 127) / 128 * 128;
}

template <int D>
struct Tile {
  static constexpr int PW = D < 64 ? D : 64;         // elements per panel row
  static constexpr int SW = PW * 2;                  // swizzle bytes
  static constexpr int NP = D / PW;                  // panels per row
  static constexpr int K_BYTES = BK * D * 2;         // K or V
  static constexpr int QT_BYTES = BQ * D * 2;        // Q or dO, one stage
  // ds of one q tile: BQ rows of the CTA's BK keys, two 128-byte swizzled
  // panels of 64 keys (one a warpgroup)
  static constexpr int DS_BYTES = BQ * BK * 2;
  // dQ: each warpgroup sums the CTA's keys for D / 2 of the columns,
  // staged in f32 boxes of FW columns (128- or 64-byte swizzled rows)
  static constexpr int DQN = D / 2;
  static constexpr int FW = DQN < 32 ? DQN : 32;
  static constexpr int FSW = FW * 4;
  static constexpr int NFB = DQN / FW;
  static constexpr int DQS_BYTES = BQ * D * 4;       // one staging buffer
  static constexpr int BARS = 8 * (1 + 3 * 4 + 4);
  // K and V, two ds and two dQ staging buffers, then the Q / dO ring and
  // its lse2 / di vectors, as many stages (2-4) as fit
  static constexpr int FIXED =
      1024 + 2 * K_BYTES + 2 * DS_BYTES + 2 * DQS_BYTES + BARS;
  static constexpr int STAGE = 2 * QT_BYTES + 2 * BQ * 4;
  static constexpr int STAGES = FIXED + 4 * STAGE <= SMEM_MAX   ? 4
                                : FIXED + 3 * STAGE <= SMEM_MAX ? 3
                                                                : 2;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

struct Args {
  int S, Hkv, G, causal, window;
  float scale;
  const float* stat;   // (B, Hq, 2, Sp): lse * log2(e), then di
  unsigned* turn;      // (B, Hq, Sp / 64): dQ contributions so far
};

// FULL (neither mask; Whisper's encoder and cross-attention): S is the key
// length and Sq the query length. The square instantiation keeps Args, so
// its parameters and code stay as they were.
struct ArgsFull : Args {
  int Sq;
};

template <bool FULL> struct ArgsOf { using type = Args; };
template <> struct ArgsOf<true> { using type = ArgsFull; };

// the query length: S in a square call
__device__ __forceinline__ int q_len(const Args& a) { return a.S; }
__device__ __forceinline__ int q_len(const ArgsFull& a) { return a.Sq; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// f32 accumulator fragments rounded to bf16: the A fragments of a product
// whose k runs along the accumulator's columns (mma.sync's layout, per
// warp)
template <int N>
__device__ __forceinline__ void pack_a(unsigned (&a)[N / 16][4],
                                       const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// acc (64 x 64) = A B^T over D: A the warpgroup's 64 rows at a_lo (rows
// a_rows apart between panels), B 64 rows at b_lo (b_rows apart), both
// K-major in 128- (or 64-) byte swizzled panels; k-step kk is 32 bytes
// into a panel row
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a_lo,
                                         int a_rows, uint32_t b_lo,
                                         int b_rows) {
  using T = Tile<D>;
  constexpr uint32_t HI = desc_hi(8 * T::SW, T::SW);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (T::PW / 16), off = (kk % (T::PW / 16)) * 32;
    wgmma_ss<64>(acc, make_desc(a_lo + ((c * a_rows * T::SW + off) >> 4), HI),
                 make_desc(b_lo + ((c * b_rows * T::SW + off) >> 4), HI), kk);
  }
}

// acc (64 x D) += A B over 64 k: A's four k-steps in registers, B (64 rows
// of D) at b_lo read MN-major, its lbo the panel stride
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const unsigned (&a)[4][4],
                                         uint32_t b_lo) {
  using T = Tile<D>;
  constexpr uint32_t HI = desc_hi(8 * T::SW, T::SW);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_tb<D>(acc, a[kk], make_desc(b_lo + ((kk * 16 * T::SW) >> 4), HI),
                   1);
}

// the warpgroup's 64 x D accumulator, times mul, rounded to bf16 into its
// own 64 rows of a tile at t (panels of ``rows`` rows), swizzled as the
// store map's box: 16-byte chunk c of row r lies at chunk c ^ (r % 8)
// (128-byte rows) or c ^ (r / 2 % 4) (64-byte rows)
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t t, int rows,
                                           const float (&acc)[D / 2],
                                           float mul, int wrow, int tig) {
  using T = Tile<D>;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wrow + 8 * hr;
    const int swz = T::SW == 128 ? (r & 7) : ((r >> 1) & 3);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = i / (T::PW / 8), chunk = i % (T::PW / 8);
      st_shared_u32(t + c * rows * T::SW + r * T::SW + ((chunk ^ swz) << 4) +
                        tig * 4,
                    pack_bf16(acc[4 * i + 2 * hr] * mul,
                              acc[4 * i + 2 * hr + 1] * mul));
    }
  }
}

// -------------------------------------------------------------- stat
// stat[b, h, 0, s] = lse * log2(e) and stat[b, h, 1, s] = sum_c o[b, s, h,
// c] * do[b, s, h, c] in f32 for s < S; +inf and 0 for S <= s < Sp. One
// CTA per (64-row q tile, q head, batch), a warp every eighth row; it also
// zeroes the tile's turn counter.
template <int D>
__global__ void __launch_bounds__(256)
stat_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout,
            const float* lse, float* stat, unsigned* turn, int S, int Hq) {
  constexpr int PER = D / 32;                        // 1, 2 or 4 elements
  __shared__ float di_s[BQ];
  const int s0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sp = stat_len(S);
  float a[BQ / 8][PER], c[BQ / 8][PER];
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const int s = min(s0 + warp + 8 * i, S - 1);
    const long long at = (((long long)b * S + s) * Hq + h) * D + lane * PER;
    load_span<__nv_bfloat16, PER>(o + at, a[i]);
    load_span<__nv_bfloat16, PER>(dout + at, c[i]);
  }
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) sum += a[i][e] * c[i][e];
    sum = warp_sum(sum);
    if (lane == 0) di_s[warp + 8 * i] = s0 + warp + 8 * i < S ? sum : 0.f;
  }
  __syncthreads();
  const long long bh = (long long)b * Hq + h;
  float* out = stat + bh * 2 * Sp + s0;
  const int r = threadIdx.x & (BQ - 1), s = s0 + r;
  if (threadIdx.x < BQ)
    out[r] = s < S ? lse[bh * S + s] * LOG2E : INFINITY;
  else if (threadIdx.x < 2 * BQ)
    out[Sp + r] = di_s[r];
  else if (threadIdx.x == 2 * BQ)
    turn[bh * (Sp / BQ) + blockIdx.x] = 0;
}

// -------------------------------------------------------------- dK, dV, dQ
// FULL: every key tile walks every q tile of Sq, and the only mask is the
// key tail past S (a zero K row gives s = 0, whose p is not 0 under FULL);
// the square instantiation's code is as it was.
template <int D, bool FULL = false>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdk,
           const __grid_constant__ CUtensorMap tdv,
           const __grid_constant__ CUtensorMap tacc,
           const typename ArgsOf<FULL>::type p) {
  using T = Tile<D>;
  constexpr int SW = T::SW, PW = T::PW, ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned tiles: the swizzle pattern follows address bits
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + T::K_BYTES;
  const uint32_t ds_s = v_s + T::K_BYTES;                 // [2]
  const uint32_t dqs_s = ds_s + 2 * T::DS_BYTES;          // [2]
  const uint32_t q_r = dqs_s + 2 * T::DQS_BYTES;          // [ST]
  const uint32_t do_r = q_r + ST * T::QT_BYTES;           // [ST]
  const uint32_t st_r = do_r + ST * T::QT_BYTES;          // [ST][2][BQ]
  const float* st_f =
      reinterpret_cast<const float*>(smem_raw + (st_r - raw));
  // mbarriers: K and V full; per stage Q full, dO full, empty; per dQ
  // staging buffer full (the 8 consumer warps) and empty (the writer)
  const uint32_t bars = st_r + ST * 2 * BQ * 4;
  const uint32_t kv_full = bars;
  auto q_full = [&](int s) { return bars + 8 * (1 + s); };
  auto do_full = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto dq_full = [&](int i) { return bars + 8 * (1 + 3 * ST + i); };
  auto dq_empty = [&](int i) { return bars + 8 * (3 + 3 * ST + i); };
  auto stage = [](int n) { return n % ST; };
  auto parity = [](int n) { return unsigned(n / ST) & 1; };

  const int S = p.S, G = p.G, Sp = stat_len(q_len(p)), W = p.window;
  const int hk = blockIdx.y, b = blockIdx.z;
  // a (batch, kv head)'s key tiles are launched together, the last first:
  // their dQ sums stay in L2, and each q tile's sum runs in that order
  const int n_kt = gridDim.x, kt = n_kt - 1 - blockIdx.x;
  const int k0 = kt * BK;
  // the q rows that see a key of this tile, [q_lo, q_hi), in BQ-row tiles
  // [t_lo, t_lo + n_t), for each of the G q heads
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = W ? min(S, k0 + BK - 1 + W) : q_len(p);
  const int t_lo = q_lo / BQ, n_t = (q_hi + BQ - 1) / BQ - t_lo;
  const int n_it = G * n_t;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(do_full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(dq_full(i), CONSUMER_WARPS);
      mbar_init(dq_empty(i), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_WARPS * 32) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      // ----------------------------------------------------- loads
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(kv_full, 2 * T::K_BYTES);
      for (int c = 0; c < T::NP; ++c) {
        tma_load_4d(k_s + c * BK * SW, &tk, kv_full, c * PW, hk, k0, b);
        tma_load_4d(v_s + c * BK * SW, &tv, kv_full, c * PW, hk, k0, b);
      }
      for (int n = 0; n < n_it; ++n) {
        const int s = stage(n), h = hk * G + n / n_t;
        const int r0 = (t_lo + n % n_t) * BQ;
        const float* st_g =
            p.stat + ((size_t)b * G * p.Hkv + h) * 2 * Sp + r0;
        mbar_wait(empty(s), parity(n) ^ 1);
        mbar_expect_tx(q_full(s), T::QT_BYTES + BQ * 4);
        for (int c = 0; c < T::NP; ++c)
          tma_load_4d(q_r + s * T::QT_BYTES + c * BQ * SW, &tq, q_full(s),
                      c * PW, h, r0, b);
        bulk_load(st_r + s * 2 * BQ * 4, st_g, BQ * 4, q_full(s));
        mbar_expect_tx(do_full(s), T::QT_BYTES + BQ * 4);
        for (int c = 0; c < T::NP; ++c)
          tma_load_4d(do_r + s * T::QT_BYTES + c * BQ * SW, &tdo, do_full(s),
                      c * PW, h, r0, b);
        bulk_load(st_r + (s * 2 + 1) * BQ * 4, st_g + Sp, BQ * 4, do_full(s));
      }
    } else if (threadIdx.x == CONSUMER_WARPS * 32 + 32) {
      // ----------------------------------------------------- dQ writer
      // Each q tile's dQ is summed in f32 in the workspace over the key
      // tiles that see it, the last first (their launch order): its turn
      // counter says how many have added theirs. The first stores, the
      // others add (TMA reduce); the staging buffer is handed back once
      // read, the turn passed on once the writes are complete. Under
      // causal, key tile kt reaches q tile t t - 2 kt tiles into its walk,
      // two tiles after key tile kt + 1 did, so turns are rarely waited
      // for.
      tma_prefetch_map(&tacc);
      for (int n = 0; n < n_it; ++n) {
        const int i = n & 1, h = hk * G + n / n_t, t = t_lo + n % n_t;
        // this key tile's place among those that see q tile t: under
        // causal (a window or not) key tiles t / 2 down to the first, else
        // the last down to the first
        const unsigned rank = (p.causal ? t / 2 : n_kt - 1) - kt;
        unsigned* flag = p.turn + ((size_t)b * G * p.Hkv + h) * (Sp / BQ) + t;
        mbar_wait(dq_full(i), unsigned(n >> 1) & 1);
        while (ld_acquire(flag) != rank) {
        }
        fence_async_global();
        const uint32_t src = dqs_s + i * T::DQS_BYTES;
        for (int w = 0; w < 2; ++w)
          for (int f = 0; f < T::NFB; ++f) {
            const uint32_t box =
                src + w * BQ * T::DQN * 4 + f * BQ * T::FSW;
            const int c0 = w * T::DQN + f * T::FW;
            if (rank == 0)
              tma_store_4d(&tacc, box, c0, BQ * t, h, b);
            else
              tma_reduce_add_4d(&tacc, box, c0, BQ * t, h, b);
          }
        tma_store_commit();
        tma_store_wait();                  // the staging buffer is read
        mbar_arrive(dq_empty(i));
        tma_store_wait_all();              // the sums are written
        fence_async_global();
        __threadfence();
        atomicAdd(flag, 1u);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
    const int wrow = (warp & 3) * 16 + g;        // row g of the warp's 16
    const int kw = k0 + wg * 64;                 // the warpgroup's first key
    const int key[2] = {kw + wrow, kw + wrow + 8};
    const float sl2 = p.scale * LOG2E;
    const uint32_t k_lo = desc_lo(k_s + wg * 64 * SW, 16);
    const uint32_t v_lo = desc_lo(v_s + wg * 64 * SW, 16);
    // dQ's B: the K tile's columns [wg * DQN, + DQN), read MN-major
    constexpr int DC = T::DQN;
    const uint32_t kq_lo =
        desc_lo(k_s + (wg * DC / PW) * BK * SW + (wg * DC % PW) * 2, BK * SW);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float sc[32], dp[32];        // s^T then p^T; dp^T then ds^T: 64 x 64
    unsigned pa[4][4], da[4][4];
    float dq[DC / 2];            // the q tile's dQ, this warpgroup's columns

    // s^T = K Q^T and dp^T = V dO^T of the CTA's n-th q tile: two groups
    auto issue_sdp = [&](int n) {
      const int s = stage(n);
      mbar_wait(q_full(s), parity(n));
      fence_regs(sc);
      wgmma_fence();
      issue_ss<D>(sc, opaque(k_lo), BK, desc_lo(q_r + s * T::QT_BYTES, 16),
                  BQ);
      wgmma_commit();
      mbar_wait(do_full(s), parity(n));
      fence_regs(dp);
      wgmma_fence();
      issue_ss<D>(dp, opaque(v_lo), BK, desc_lo(do_r + s * T::QT_BYTES, 16),
                  BQ);
      wgmma_commit();
    };
    // p^T of the n-th q tile in sc: element (key row g or g + 8, q column
    // 8 j + 2 tig (+1)). Masks only tiles that cross the diagonal or the
    // window's edge, under FULL the key tail (rows past Sq carry lse2 =
    // +inf, so their p is 0).
    auto probs = [&](int n) {
      const int r0 = (t_lo + n % n_t) * BQ;
      if constexpr (FULL) {
        if (kw + 63 >= S) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (key[e >> 1] >= S) sc[4 * j + e] = -INFINITY;
        }
      } else if ((p.causal && kw + 63 > r0) || (W && r0 + BQ - 1 - kw >= W)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * j + 2 * tig + (e & 1), c = key[e >> 1];
            if ((p.causal && c > r) || (W && r - c >= W))
              sc[4 * j + e] = -INFINITY;
          }
      }
      const float* lse2 = st_f + stage(n) * 2 * BQ;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, (e & 1) ? -l.y : -l.x));
      }
    };
    // ds^T = p^T (dp^T - di) of the n-th q tile in dp
    auto grads = [&](int n) {
      const float* di = st_f + stage(n) * 2 * BQ + BQ;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(di + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
      }
    };
    // ds (q rows x the CTA's keys) into ds buffer i, K-major for the dQ
    // product: the ds^T fragments stored transposed, 8 keys (16 bytes) a
    // memory row; key chunk c of q row r at chunk c ^ (r % 8) of the
    // warpgroup's 128-byte swizzled panel
    auto store_ds = [&](int i) {
      const int m = lane >> 3, chunk = 2 * (warp & 3) + (m & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = 16 * kk + (m >> 1) * 8 + (lane & 7);
        stmatrix_x4_trans(ds_s + i * T::DS_BYTES + wg * BQ * 128 + r * 128 +
                              ((chunk ^ (r & 7)) << 4),
                          da[kk][0], da[kk][1], da[kk][2], da[kk][3]);
      }
    };
    // dV += p^T dO and dK += ds^T Q of the n-th q tile: one group
    auto issue_dkdv = [&](int n) {
      const int s = stage(n);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      issue_rs<D>(dv, pa, desc_lo(do_r + s * T::QT_BYTES, BQ * SW));
      issue_rs<D>(dk, da, desc_lo(q_r + s * T::QT_BYTES, BQ * SW));
      wgmma_commit();
    };
    // dQ (64 q rows x DC) = ds K over the CTA's 128 keys, ds from buffer i
    auto issue_dq = [&](int i) {
      constexpr uint32_t HA = desc_hi(8 * 128, 128);
      constexpr uint32_t HB = desc_hi(8 * SW, SW);
      const uint32_t a_lo = desc_lo(ds_s + i * T::DS_BYTES, 16);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_tb<DC>(
            dq,
            make_desc(a_lo + (((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4), HA),
            make_desc(opaque(kq_lo) + ((kk * 16 * SW) >> 4), HB), kk);
      wgmma_commit();
    };
    // after the n-th tile's products: its ring slot is free
    auto done = [&](int n) {
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      if (lane == 0) mbar_arrive(empty(stage(n)));
    };
    // the warpgroup's dQ in f32 into staging buffer i for the writer:
    // column c in box c / FW, its 16-byte chunk swizzled by the row
    auto stage_dq = [&](int n) {
      const int i = n & 1;
      mbar_wait(dq_empty(i), (unsigned(n >> 1) & 1) ^ 1);
      const uint32_t dst = dqs_s + i * T::DQS_BYTES + wg * BQ * DC * 4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wrow + 8 * hr;
        const int swz = T::FSW == 128 ? (r & 7) : ((r >> 1) & 3);
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          const int c = 8 * j + 2 * tig, f = c / T::FW, cc = c % T::FW;
          const uint32_t at = dst + f * BQ * T::FSW + r * T::FSW +
                              (((cc >> 2) ^ swz) << 4) + (cc & 3) * 4;
          st_shared_u32(at, __float_as_uint(dq[4 * j + 2 * hr]));
          st_shared_u32(at + 4, __float_as_uint(dq[4 * j + 2 * hr + 1]));
        }
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_full(i));
    };

    mbar_wait(kv_full, 0);
    for (int n = 0; n < n_it; ++n) {
      issue_sdp(n);
      wgmma_wait<1>();                     // s^T; p^T under dp^T
      fence_regs(sc);
      probs(n);
      pack_a<64>(pa, sc);
      wgmma_wait<0>();                     // dp^T
      fence_regs(dp);
      grads(n);
      pack_a<64>(da, dp);
      store_ds(n & 1);
      fence_async_shared();
      issue_dkdv(n);
      named_sync(3, 256);                  // both warpgroups' ds stored
      issue_dq(n & 1);
      wgmma_wait<0>();
      done(n);
      stage_dq(n);
    }

    // dK scaled and dV, staged in the warpgroup's own rows of the K and V
    // tiles once both warpgroups' products (dQ reads every K row) are
    // done, stored by TMA, which drops keys past S
    named_sync(3, 256);
    stage_rows<D>(k_s + wg * 64 * SW, BK, dk, p.scale, wrow, tig);
    stage_rows<D>(v_s + wg * 64 * SW, BK, dv, 1.f, wrow, tig);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
      for (int c = 0; c < T::NP; ++c) {
        tma_store_4d(&tdk, k_s + c * BK * SW + wg * 64 * SW, c * PW, hk, kw,
                     b);
        tma_store_4d(&tdv, v_s + c * BK * SW + wg * 64 * SW, c * PW, hk, kw,
                     b);
      }
      tma_store_commit();
      tma_store_wait();
    }
  }
}

// -------------------------------------------------------------- dq
// dq[b, s, h] = scale * acc[b, h, s] rounded to bf16: one warp a row
template <int D>
__global__ void __launch_bounds__(256)
dq_out_kernel(const float* acc, __nv_bfloat16* dq, int S, int Hq,
              float scale, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = (int)(row % Hq);
  const long long bs = row / Hq;                    // row = (b * S + s) Hq + h
  const int s = (int)(bs % S);
  const long long b = bs / S;
  constexpr int PER = D / 32;
  float v[PER];
  load_span<float, PER>(acc + ((b * Hq + h) * stat_len(S) + s) * D +
                            lane * PER, v);
  __nv_bfloat16* out = dq + row * D + lane * PER;
  if constexpr (PER == 1) {
    out[0] = __float2bfloat16(v[0] * scale);
  } else {
#pragma unroll
    for (int i = 0; i < PER; i += 2)
      *reinterpret_cast<unsigned*>(out + i) =
          pack_bf16(v[i] * scale, v[i + 1] * scale);
  }
}

// ------------------------------------------------- d 256 and (192, 128)
// The widths whose dK and dV do not fit bwd_kernel's registers (64 keys a
// warpgroup holding every column: 256 f32 a thread at d 256):
// RecurrentGemma's local attention at d 256 (16 q heads on one kv head)
// and MLA's (192, 128). bwd_kernel's shape, with the head dimension split
// across the two consumer warpgroups instead of the keys: one CTA per
// (64-key tile, kv head, batch, head group). Per q tile (64 rows), each
// warpgroup
//   s^T = K Q^T, dp^T = V dO^T     wgmma m64n32: the 64 keys x its 32 q
//                                  rows, over the whole width
//   p^T, ds^T -> shared memory     bf16, a 64 x 64 tile each, keys as rows
//   (named barrier: both halves stored)
//   dV[:, half] += p^T dO[:, half]  A from shared memory (K-major), B the
//   dK[:, half] += ds^T Q[:, half]  stage's dO / Q (MN-major), k = 64 q
//   dQ[:, half] = ds K[:, half]     A the ds^T tile read MN-major, k = 64
//                                   keys
// so p is formed once (five products). A thread holds dK 64 + dV 64 + dQ
// 64 f32 at d 256 (48 + 32 + 48 at (192, 128)), and s, dp 16 each outside
// the dQ product. A half is one wgmma piece of d / 2 columns, or at 192
// (no N 96) 64 columns from 128 wg and 32 from 64 + 32 wg: both
// warpgroups issue the same sequence. Once both warpgroups' products of
// the tile are done (a second named barrier), the stage's Q and dO are
// read, and each warpgroup stages its dQ columns in f32 in that stage
// (boxes of 32 columns, 128-byte swizzled; a stage holds max(Q + dO, dQ in
// f32): 64 KB at d 256, 48 KB at (192, 128)); the writer adds them into
// the (B, Hq, Sp, dk) workspace by TMA as bwd_kernel's does (a store for
// the first key tile of a q tile, cp.reduce.async.bulk .add for the
// others, the last key tile first, under the turn counters), then frees
// the stage for the loader. Shared memory: K, V, p^T, ds^T and the ring
// (2 stages at d 256, 215,112 bytes; 3 at (192, 128), 207,464). A group's
// key tiles launch the first (the longest causal band) first where they
// fit the card's SMs at once, else the last first, as bwd_kernel's.
// The grid: where (key tiles, kv heads, batch) fill less than one wave of
// the card's SMs (RecurrentGemma: 47 x 1 x 2 = 94 on 132), the G q heads
// of a kv head are split over ``split`` CTAs (the divisor of G that packs
// the most work into the fewest waves, wide_split); each writes its dK /
// dV in f32 to a partial of the scratch, and wide_sum_kernel sums the
// partials in split order and rounds once: no CTA waits on another for
// them, so the split adds no ordering constraint. Otherwise dK and dV
// (dK scaled) are staged in bf16 in the K and V tiles and stored by TMA.
// Masks as in bwd_kernel, only on tiles that cross the diagonal, the
// window's edge or Sk (keys past Sk are masked in every mode: under a
// window without the causal mask, as under FULL, a zero key's p need not
// be small).
constexpr int PANEL = 64 * 128;          // 64 rows of 128 bytes

template <int DK, int DV>
struct Wide {
  static constexpr int K_BYTES = BQ * DK * 2;        // the 64 keys' K
  static constexpr int V_BYTES = BQ * DV * 2;
  static constexpr int Q_BYTES = BQ * DK * 2;        // a q tile's Q
  static constexpr int DO_BYTES = BQ * DV * 2;
  static constexpr int DQ_BYTES = BQ * DK * 4;       // its dQ in f32
  static constexpr int STAGE =
      Q_BYTES + DO_BYTES > DQ_BYTES ? Q_BYTES + DO_BYTES : DQ_BYTES;
  static constexpr int PS_BYTES = BQ * BQ * 2;       // p^T or ds^T
  static constexpr int FIXED = 1024 + K_BYTES + V_BYTES + 2 * PS_BYTES;
  // a stage with its lse2 and di, and its four mbarriers
  static constexpr int PER_STAGE = STAGE + 2 * BQ * 4 + 4 * 8;
  static constexpr int STAGES = FIXED + 8 + 3 * PER_STAGE <= SMEM_MAX ? 3 : 2;
  static constexpr int SMEM = FIXED + 8 + STAGES * PER_STAGE;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

struct WideArgs {
  int Sq, Sk, Hkv, G, causal, window, split;
  int heavy_first;     // launch a group's key tiles from the first
  float scale;
  const float* stat;   // (B, Hq, 2, Sp): lse * log2(e), then di
  unsigned* turn;      // (B, Hq, Sp / 64): dQ contributions so far
  float* part;         // split > 1: dK (split, B, Hkv, Skp, dk), then dV's
};

// A warpgroup's half of a width D as wgmma pieces (see above)
template <int D>
struct Half {
  static constexpr int N0 = D == 192 ? 64 : D / 2;
  static constexpr int N1 = D == 192 ? 32 : 0;
  float a[N0 / 2];
  float b[N1 ? N1 / 2 : 1];
  __device__ __forceinline__ static int c0(int wg) {
    return D == 192 ? 128 * wg : D / 2 * wg;
  }
  __device__ __forceinline__ static int c1(int wg) { return 64 + 32 * wg; }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N0 / 2; ++i) a[i] = 0.f;
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) b[i] = 0.f;
  }
  __device__ __forceinline__ void fence() {
    fence_regs(a);
    if constexpr (N1 > 0) fence_regs(b);
  }
  // f(piece, its first column) for each piece
  template <typename F>
  __device__ __forceinline__ void each(int wg, F&& f) {
    f(a, c0(wg));
    if constexpr (N1 > 0) f(b, c1(wg));
  }
};

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float x,
                                             float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// the byte address of column c, row 0, in a tile of 128-byte swizzled
// panels of 64 bf16 columns (64 rows each), before the swizzle
__device__ __forceinline__ uint32_t col_at(uint32_t tile, int c) {
  return tile + (c >> 6) * PANEL + (c & 63) * 2;
}

// acc (64 keys x 32 q) = A B^T over D: A the CTA's 64 keys (the K or V
// tile at a_lo), B the warpgroup's 32 q rows of the stage's Q or dO (at
// b_lo); both K-major in panels of 64 columns, PANEL bytes apart; k-step
// kk 32 bytes into a panel row
template <int D>
__device__ __forceinline__ void issue_st(float (&acc)[16], uint32_t a_lo,
                                         uint32_t b_lo) {
  constexpr uint32_t HI = desc_hi(8 * 128, 128);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = ((kk / 4) * PANEL + (kk % 4) * 32) >> 4;
    wgmma_ss<32>(acc, make_desc(a_lo + off, HI), make_desc(b_lo + off, HI),
                 kk);
  }
}

template <int N, bool TA>
__device__ __forceinline__ void mma_kn(float (&acc)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (TA)
    wgmma_ss_tt<N>(acc, a, b, scale_d);
  else
    wgmma_ss_tb<N>(acc, a, b, scale_d);
}

// acc (64 rows x the warpgroup's half of D) = A B, plus acc where acc_in:
// k = 64 rows; A a 64 x 64 tile at a_lo, K-major (k-step 32 bytes on) or,
// TA, MN-major (k-step 16 rows on); B the half's columns of a tile of
// panels at ``tile``, MN-major (k-step 16 rows on, panels PANEL apart)
template <int D, bool TA>
__device__ __forceinline__ void issue_half(Half<D>& acc, uint32_t a_lo,
                                           uint32_t tile, int wg,
                                           int acc_in) {
  using H = Half<D>;
  constexpr uint32_t HI = desc_hi(8 * 128, 128);
  const uint32_t b0 = desc_lo(col_at(tile, H::c0(wg)), PANEL);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_kn<H::N0, TA>(acc.a, make_desc(a_lo + (TA ? kk * 128 : kk * 2), HI),
                      make_desc(b0 + kk * 128, HI), acc_in || kk);
  if constexpr (H::N1 > 0) {
    const uint32_t b1 = desc_lo(col_at(tile, H::c1(wg)), PANEL);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_kn<H::N1, TA>(acc.b,
                        make_desc(a_lo + (TA ? kk * 128 : kk * 2), HI),
                        make_desc(b1 + kk * 128, HI), acc_in || kk);
  }
}

// a piece (the warpgroup's 64 rows x 2 M columns from c0) times mul,
// rounded to bf16, into a tile of 128-byte swizzled panels: 16-byte chunk
// x of row r at chunk x ^ (r % 8)
template <int M>
__device__ __forceinline__ void put_bf16(uint32_t tile, int c0,
                                         const float (&acc)[M], float mul,
                                         int wrow, int tig) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wrow + 8 * hr;
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
      const int c = c0 + 8 * j + 2 * tig;
      st_shared_u32(
          tile + (c >> 6) * PANEL + r * 128 +
              ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2,
          pack_bf16(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul));
    }
  }
}

// a piece in f32 into boxes of 32 columns (PANEL bytes apart, 128-byte
// rows, swizzled as above): the dQ workspace's TMA boxes
template <int M>
__device__ __forceinline__ void put_f32(uint32_t tile, int c0,
                                        const float (&acc)[M], int wrow,
                                        int tig) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wrow + 8 * hr;
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
      const int c = c0 + 8 * j + 2 * tig;
      st_shared_v2(tile + (c >> 5) * PANEL + r * 128 +
                       ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4,
                   acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

// a piece in f32 into rows of ld floats in global memory
template <int M>
__device__ __forceinline__ void put_global(float* rows, int ld, int c0,
                                           const float (&acc)[M], int wrow,
                                           int tig) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* row = rows + (long long)(wrow + 8 * hr) * ld + c0 + 2 * tig;
#pragma unroll
    for (int j = 0; j < M / 4; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
wide_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdk,
            const __grid_constant__ CUtensorMap tdv,
            const __grid_constant__ CUtensorMap tacc, const WideArgs p) {
  using T = Wide<DK, DV>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + T::K_BYTES;
  const uint32_t p_s = v_s + T::V_BYTES;                  // p^T
  const uint32_t ds_s = p_s + T::PS_BYTES;                // ds^T
  const uint32_t ring = ds_s + T::PS_BYTES;               // [ST]
  const uint32_t st_r = ring + ST * T::STAGE;             // [ST][2][BQ]
  const float* st_f =
      reinterpret_cast<const float*>(smem_raw + (st_r - raw));
  // mbarriers: K and V full; per stage Q full, dO full, empty (the writer
  // has read the stage's dQ), dQ staged (the 8 consumer warps)
  const uint32_t bars = st_r + ST * 2 * BQ * 4;
  const uint32_t kv_full = bars;
  auto q_full = [&](int s) { return bars + 8 * (1 + s); };
  auto do_full = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto dq_full = [&](int s) { return bars + 8 * (1 + 3 * ST + s); };
  auto stage = [](int n) { return n % ST; };
  auto parity = [](int n) { return unsigned(n / ST) & 1; };

  const int Sq = p.Sq, Sk = p.Sk, W = p.window, Sp = stat_len(Sq);
  const int hk = blockIdx.y / p.split, b = blockIdx.z;
  const int Hq = p.G * p.Hkv, Gs = p.G / p.split;
  const int h0 = hk * p.G + (blockIdx.y % p.split) * Gs;  // first q head
  // a (batch, kv head, head group)'s key tiles are launched together: the
  // first (the longest band under causal) first where the group fits the
  // card at once, else the last first (bwd_kernel's order), so that a CTA
  // that waits for a turn only waits on CTAs that can run
  const int n_kt = gridDim.x;
  const int kt = p.heavy_first ? blockIdx.x : n_kt - 1 - blockIdx.x;
  const int k0 = kt * BQ;
  // the q rows that see a key of this tile, [q_lo, q_hi), in BQ-row tiles
  // [t_lo, t_lo + n_t), for each of the CTA's Gs q heads
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = W ? min(Sq, k0 + BQ - 1 + W) : Sq;
  const int t_lo = q_lo / BQ, n_t = (q_hi + BQ - 1) / BQ - t_lo;
  const int n_it = Gs * n_t;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(do_full(s), 1);
      mbar_init(empty(s), 1);
      mbar_init(dq_full(s), CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_WARPS * 32) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      // ----------------------------------------------------- loads
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(kv_full, T::K_BYTES + T::V_BYTES);
      for (int c = 0; c < DK / 64; ++c)
        tma_load_4d(k_s + c * PANEL, &tk, kv_full, c * 64, hk, k0, b);
      for (int c = 0; c < DV / 64; ++c)
        tma_load_4d(v_s + c * PANEL, &tv, kv_full, c * 64, hk, k0, b);
      for (int n = 0; n < n_it; ++n) {
        const int s = stage(n), h = h0 + n / n_t;
        const int r0 = (t_lo + n % n_t) * BQ;
        const float* st_g = p.stat + ((size_t)b * Hq + h) * 2 * Sp + r0;
        const uint32_t qt = ring + s * T::STAGE;
        mbar_wait(empty(s), parity(n) ^ 1);
        mbar_expect_tx(q_full(s), T::Q_BYTES + BQ * 4);
        for (int c = 0; c < DK / 64; ++c)
          tma_load_4d(qt + c * PANEL, &tq, q_full(s), c * 64, h, r0, b);
        bulk_load(st_r + s * 2 * BQ * 4, st_g, BQ * 4, q_full(s));
        mbar_expect_tx(do_full(s), T::DO_BYTES + BQ * 4);
        for (int c = 0; c < DV / 64; ++c)
          tma_load_4d(qt + T::Q_BYTES + c * PANEL, &tdo, do_full(s), c * 64,
                      h, r0, b);
        bulk_load(st_r + (s * 2 + 1) * BQ * 4, st_g + Sp, BQ * 4,
                  do_full(s));
      }
    } else if (threadIdx.x == CONSUMER_WARPS * 32 + 32) {
      // ----------------------------------------------------- dQ writer
      // As bwd_kernel's, from the ring stage the tile was loaded into; the
      // stage goes back to the loader once read. Under causal the key
      // tiles of q tile t are t down to the first that sees it.
      tma_prefetch_map(&tacc);
      for (int n = 0; n < n_it; ++n) {
        const int s = stage(n), h = h0 + n / n_t, t = t_lo + n % n_t;
        const unsigned rank = (p.causal ? t : n_kt - 1) - kt;
        unsigned* flag = p.turn + ((size_t)b * Hq + h) * (Sp / BQ) + t;
        mbar_wait(dq_full(s), parity(n));
        while (ld_acquire(flag) != rank) {
        }
        fence_async_global();
        for (int f = 0; f < DK / 32; ++f) {
          const uint32_t box = ring + s * T::STAGE + f * PANEL;
          if (rank == 0)
            tma_store_4d(&tacc, box, f * 32, BQ * t, h, b);
          else
            tma_reduce_add_4d(&tacc, box, f * 32, BQ * t, h, b);
        }
        tma_store_commit();
        tma_store_wait();                  // the stage is read
        mbar_arrive(empty(s));
        tma_store_wait_all();              // the sums are written
        fence_async_global();
        __threadfence();
        atomicAdd(flag, 1u);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
    const int wrow = (warp & 3) * 16 + g;        // row g of the warp's 16
    const int key[2] = {k0 + wrow, k0 + wrow + 8};
    const float sl2 = p.scale * LOG2E;
    const uint32_t k_lo = desc_lo(k_s, 16), v_lo = desc_lo(v_s, 16);

    Half<DK> dk;
    Half<DV> dv;
    dk.zero();
    dv.zero();
    mbar_wait(kv_full, 0);
    for (int n = 0; n < n_it; ++n) {
      const int s = stage(n);
      const uint32_t qt = ring + s * T::STAGE, dot = qt + T::Q_BYTES;
      // s^T then p^T; dp^T then ds^T: the 64 keys x this warpgroup's 32 q
      // rows. Fresh each tile, as is dQ: nothing of the last tile's stays
      // live across this one's products.
      float sc[16], dp[16];
      Half<DK> dq;
      mbar_wait(q_full(s), parity(n));
      wgmma_fence();
      issue_st<DK>(sc, opaque(k_lo), desc_lo(qt + wg * 32 * 128, 16));
      wgmma_commit();
      mbar_wait(do_full(s), parity(n));
      wgmma_fence();
      issue_st<DV>(dp, opaque(v_lo), desc_lo(dot + wg * 32 * 128, 16));
      wgmma_commit();
      wgmma_wait<1>();                     // s^T; p^T under dp^T
      fence_regs(sc);
      // element (key key[e / 2], q row qc + 8 j + 2 tig + e % 2); masked
      // only on tiles that cross the diagonal, the window's edge or Sk
      // (rows past Sq carry lse2 = +inf, so their p is 0)
      const int qc = (t_lo + n % n_t) * BQ + 32 * wg;
      if (k0 + BQ - 1 >= Sk || (p.causal && k0 + BQ - 1 > qc) ||
          (W && qc + 31 - k0 >= W)) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = qc + 8 * j + 2 * tig + (e & 1), c = key[e >> 1];
            if (c >= Sk || (p.causal && c > r) || (W && r - c >= W))
              sc[4 * j + e] = -INFINITY;
          }
      }
      const float* stv = st_f + s * 2 * BQ + 32 * wg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(stv + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, (e & 1) ? -l.y : -l.x));
      }
      put_bf16(p_s, 32 * wg, sc, 1.f, wrow, tig);
      wgmma_wait<0>();                     // dp^T
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 d =
            *reinterpret_cast<const float2*>(stv + BQ + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
      }
      put_bf16(ds_s, 32 * wg, dp, 1.f, wrow, tig);
      fence_async_shared();
      named_sync(3, 256);                  // both halves of p^T, ds^T
      dk.fence();
      dv.fence();
      wgmma_fence();
      issue_half<DV, false>(dv, desc_lo(p_s, 16), dot, wg, 1);
      issue_half<DK, false>(dk, desc_lo(ds_s, 16), qt, wg, 1);
      issue_half<DK, true>(dq, desc_lo(ds_s, PANEL), k_s, wg, 0);
      wgmma_commit();
      wgmma_wait<0>();
      dk.fence();
      dv.fence();
      dq.fence();
      // both warpgroups' products are done: the stage's Q and dO, p^T and
      // ds^T are read; dQ in f32 into the stage for the writer
      named_sync(4, 256);
      dq.each(wg, [&](auto& piece, int c0) {
        put_f32(qt, c0, piece, wrow, tig);
      });
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_full(s));
    }

    if (p.split == 1) {
      // dK scaled and dV, rounded to bf16, each warpgroup its columns, in
      // the K and V tiles (read for the last time before the last tile's
      // second barrier), stored by TMA, which drops keys past Sk
      dk.each(wg, [&](auto& piece, int c0) {
        put_bf16(k_s, c0, piece, p.scale, wrow, tig);
      });
      dv.each(wg, [&](auto& piece, int c0) {
        put_bf16(v_s, c0, piece, 1.f, wrow, tig);
      });
      fence_async_shared();
      named_sync(5, 256);
      if (threadIdx.x == 0) {
        for (int c = 0; c < DK / 64; ++c)
          tma_store_4d(&tdk, k_s + c * PANEL, c * 64, hk, k0, b);
        for (int c = 0; c < DV / 64; ++c)
          tma_store_4d(&tdv, v_s + c * PANEL, c * 64, hk, k0, b);
        tma_store_commit();
        tma_store_wait();
      }
    } else {
      // the head group's dK and dV in f32, rows k0.. of its partials
      const size_t at =
          ((size_t)(blockIdx.y % p.split) * gridDim.z + b) * p.Hkv + hk;
      const size_t skp = (size_t)n_kt * BQ;
      float* pk = p.part + (at * skp + k0) * DK;
      float* pv = p.part + (size_t)p.split * gridDim.z * p.Hkv * skp * DK +
                  (at * skp + k0) * DV;
      dk.each(wg, [&](auto& piece, int c0) {
        put_global(pk, DK, c0, piece, wrow, tig);
      });
      dv.each(wg, [&](auto& piece, int c0) {
        put_global(pv, DV, c0, piece, wrow, tig);
      });
    }
  }
}

// dq[b, s, h] = scale * acc[b, h, s] rounded to bf16 at d 256 / 192: one
// warp a row, two columns a lane a step
template <int D>
__global__ void __launch_bounds__(256)
wide_dq_kernel(const float* acc, __nv_bfloat16* dq, int S, int Hq,
               float scale, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = (int)(row % Hq);
  const long long bs = row / Hq;                    // row = (b * S + s) Hq + h
  const int s = (int)(bs % S);
  const long long b = bs / S;
  const float* src = acc + ((b * Hq + h) * stat_len(S) + s) * D;
  __nv_bfloat16* out = dq + row * D;
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 v = *reinterpret_cast<const float2*>(src + c);
    *reinterpret_cast<unsigned*>(out + c) =
        pack_bf16(v.x * scale, v.y * scale);
  }
}

// out[c] = mul * sum_j src[j * stride + c] over the split's partials, in
// order j = 0, 1, ...; rounded to bf16
template <int D>
__device__ __forceinline__ void sum_row(const float* src, long long stride,
                                        int split, float mul,
                                        __nv_bfloat16* out, int lane) {
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64) {
    float x = 0.f, y = 0.f;
    for (int j = 0; j < split; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(src + j * stride + c);
      x += v.x;
      y += v.y;
    }
    *reinterpret_cast<unsigned*>(out + c) = pack_bf16(x * mul, y * mul);
  }
}

// dk = scale * the sum of the head groups' dK partials, dv the sum of
// theirs, bf16: one warp a (batch, key, kv head) row
template <int DK, int DV>
__global__ void __launch_bounds__(256)
wide_sum_kernel(const float* part, __nv_bfloat16* dk, __nv_bfloat16* dv,
                int B, int Sk, int Hkv, int split, float scale) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * Sk * Hkv) return;
  const int hk = (int)(row % Hkv);
  const long long bs = row / Hkv;                 // row = (b * Sk + key) Hkv + hk
  const int key = (int)(bs % Sk);
  const long long b = bs / Sk;
  const long long skp = (Sk + BQ - 1) / BQ * BQ;
  const long long per = B * Hkv * skp;            // rows of one partial
  const long long at = (b * Hkv + hk) * skp + key;
  sum_row<DK>(part + at * DK, per * DK, split, scale, dk + row * DK, lane);
  sum_row<DV>(part + split * per * DK + at * DV, per * DV, split, 1.f,
              dv + row * DV, lane);
}

// setmaxnreg.inc waits for the registers the producer warpgroup gives
// back: refuse a build whose entry count would leave the consumers waiting
template <typename K>
bool regs_cover(K kernel) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return false;
  return (fa.numRegs - PRODUCER_REGS) * 128 >=
         (CONSUMER_REGS - fa.numRegs) * 32 * CONSUMER_WARPS;
}

// (dk, dv) that wide_kernel takes (bwd_kernel takes d 32 / 64 / 128)
bool wide_widths(int dk, int dv) {
  return (dk == 256 && dv == 256) || (dk == 192 && dv == 128);
}

// The head groups wide_kernel splits a kv head's G q heads into: 1 where
// the (key tile, kv head, batch) CTAs fill a wave of the card's ``sms``
// SMs, else the divisor of G whose CTAs leave the fewest waves a head, the
// smallest of equals (RecurrentGemma's 94 CTAs: 4, 376 CTAs in 3 waves).
int wide_split(int B, int Sk, int Hq, int Hkv, int dk, int dv, int sms) {
  if (!wide_widths(dk, dv) || sms < 1 || Hkv < 1 || Hq % Hkv) return 1;
  const long long ctas = (long long)((Sk + BQ - 1) / BQ) * Hkv * B;
  if (ctas >= sms) return 1;
  const int G = Hq / Hkv;
  int best = 1;
  long long best_waves = 1;                 // waves a head group, x best
  for (int s = 2; s <= G; ++s) {
    if (G % s) continue;
    const long long waves = (ctas * s + sms - 1) / sms;
    if (waves * best < best_waves * s) {
      best = s;
      best_waves = waves;
    }
  }
  return best;
}

// the f32 scratch a call takes, in floats: stat (B, Hq, 2, Sp), the dQ
// workspace (B, Hq, Sp, dk) of the warp-specialised kernels, the turn
// counters (B, Hq, Sp / 64); Sp from the query length; then, where
// wide_kernel splits the heads (split > 1), its dK and dV partials
// (split, B, Hkv, Skp, dk + dv), Skp = Sk rounded up to 64
long long scratch_floats(int B, int Sq, int Sk, int Hq, int Hkv, int dk,
                         int dv, int split) {
  const long long rows = (long long)B * Hq * stat_len(Sq);
  const long long n = rows * (2 + dk) + rows / BQ;
  if (split <= 1) return n;
  const long long skp = (long long)(Sk + BQ - 1) / BQ * BQ;
  return (n + 3) / 4 * 4 + (long long)split * B * Hkv * skp * (dk + dv);
}

template <int D, bool FULL>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
           int causal, int window, float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  using T = Tile<D>;
  const int Sp = stat_len(Sq);
  float* stat = scratch;
  float* acc = stat + 2LL * B * Hq * Sp;
  unsigned* turn = reinterpret_cast<unsigned*>(acc + (long long)B * Hq * Sp * D);
  stat_kernel<D><<<dim3(Sp / BQ, Hq, B), 256, 0, st>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, stat,
      turn, Sq, Hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // (B, S, H, D) contiguous: strides (head, position, batch) in elements
  const long long qh = D, qs = (long long)Hq * D, qb = qs * Sq;
  const long long kh = D, ks = (long long)Hkv * D, kb = ks * Sk;
  CUtensorMap mq, mdo, mk, mv, mdk, mdv, macc;
  if (!map_bshd_bf16(&mq, q, D, Hq, Sq, B, qh, qs, qb, T::PW, BQ) ||
      !map_bshd_bf16(&mdo, dout, D, Hq, Sq, B, qh, qs, qb, T::PW, BQ) ||
      !map_bshd_bf16(&mk, k, D, Hkv, Sk, B, kh, ks, kb, T::PW, BK) ||
      !map_bshd_bf16(&mv, v, D, Hkv, Sk, B, kh, ks, kb, T::PW, BK) ||
      !map_bshd_bf16(&mdk, dk, D, Hkv, Sk, B, kh, ks, kb, T::PW, 64) ||
      !map_bshd_bf16(&mdv, dv, D, Hkv, Sk, B, kh, ks, kb, T::PW, 64) ||
      // the dQ workspace (B, Hq, Sp, D) f32 as (D, Sp, Hq, B)
      !map_4d(&macc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, acc,
              {(cuuint64_t)D, (cuuint64_t)Sp, (cuuint64_t)Hq, (cuuint64_t)B},
              {D, (long long)Sp * D, (long long)Hq * Sp * D},
              {(cuuint32_t)T::FW, (cuuint32_t)BQ, 1, 1}, T::FSW))
    return static_cast<int>(cudaErrorInvalidValue);
  static const bool ok = regs_cover(bwd_kernel<D, FULL>);
  if (!ok) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaFuncSetAttribute(bwd_kernel<D, FULL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  typename ArgsOf<FULL>::type a;
  a.S = Sk;
  a.Hkv = Hkv;
  a.G = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.stat = stat;
  a.turn = turn;
  if constexpr (FULL) a.Sq = Sq;
  bwd_kernel<D, FULL><<<dim3((Sk + BK - 1) / BK, Hkv, B), THREADS, T::SMEM,
                         st>>>(mq, mdo, mk, mv, mdk, mdv, macc, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long qrows = (long long)B * Sq * Hq;
  dq_out_kernel<D><<<(unsigned)((qrows + 7) / 8), 256, 0, st>>>(
      acc, static_cast<bf*>(dq), Sq, Hq, scale, qrows);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* scratch, void* dq,
             void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
             int causal, int window, float scale, cudaStream_t st) {
  return causal || window
             ? launch<D, false>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B,
                                Sq, Sk, Hq, Hkv, causal, window, scale, st)
             : launch<D, true>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B,
                               Sq, Sk, Hq, Hkv, causal, window, scale, st);
}

// wide_kernel (d 256, (192, 128)): the row statistics, dK / dV / dQ with
// the q heads in ``split`` groups, dq's rounding, and the groups' dK / dV
// summed where split > 1
template <int DK, int DV>
int launch_wide(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* scratch, void* dq,
                void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                int causal, int window, int split, float scale,
                cudaStream_t st) {
  using bf = __nv_bfloat16;
  using T = Wide<DK, DV>;
  const int G = Hq / Hkv;
  if (split < 1 || G % split) return static_cast<int>(cudaErrorInvalidValue);
  const int Sp = stat_len(Sq), n_kt = (Sk + BQ - 1) / BQ;
  float* stat = scratch;
  float* acc = stat + 2LL * B * Hq * Sp;
  unsigned* turn =
      reinterpret_cast<unsigned*>(acc + (long long)B * Hq * Sp * DK);
  const long long n = scratch_floats(B, Sq, Sk, Hq, Hkv, DK, DV, 1);
  float* part = scratch + (n + 3) / 4 * 4;
  stat_kernel<DV><<<dim3(Sp / BQ, Hq, B), 256, 0, st>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, stat,
      turn, Sq, Hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // (B, S, H, d) contiguous: strides (head, position, batch) in elements
  const long long qs = (long long)Hq * DK, os = (long long)Hq * DV;
  const long long ks = (long long)Hkv * DK, vs = (long long)Hkv * DV;
  CUtensorMap mq, mdo, mk, mv, mdk, mdv, macc;
  if (!map_bshd_bf16(&mq, q, DK, Hq, Sq, B, DK, qs, qs * Sq, 64, BQ) ||
      !map_bshd_bf16(&mdo, dout, DV, Hq, Sq, B, DV, os, os * Sq, 64, BQ) ||
      !map_bshd_bf16(&mk, k, DK, Hkv, Sk, B, DK, ks, ks * Sk, 64, BQ) ||
      !map_bshd_bf16(&mv, v, DV, Hkv, Sk, B, DV, vs, vs * Sk, 64, BQ) ||
      !map_bshd_bf16(&mdk, dk, DK, Hkv, Sk, B, DK, ks, ks * Sk, 64, BQ) ||
      !map_bshd_bf16(&mdv, dv, DV, Hkv, Sk, B, DV, vs, vs * Sk, 64, BQ) ||
      // the dQ workspace (B, Hq, Sp, DK) f32 as (DK, Sp, Hq, B)
      !map_4d(&macc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, acc,
              {(cuuint64_t)DK, (cuuint64_t)Sp, (cuuint64_t)Hq, (cuuint64_t)B},
              {DK, (long long)Sp * DK, (long long)Hq * Sp * DK},
              {32, (cuuint32_t)BQ, 1, 1}, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  static const bool ok = regs_cover(wide_kernel<DK, DV>);
  if (!ok) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaFuncSetAttribute(wide_kernel<DK, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  // heaviest first where a group's key tiles can all be resident (one CTA
  // an SM): the turns of a q tile then run down from a CTA launched after
  // the one that waits, but every one of them gets an SM
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const WideArgs a{Sq,    Sk,    Hkv,  G,    causal, window, split,
                   n_kt <= sms,  scale, stat, turn,   part};
  wide_kernel<DK, DV><<<dim3(n_kt, Hkv * split, B), THREADS, T::SMEM, st>>>(
      mq, mdo, mk, mv, mdk, mdv, macc, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long qrows = (long long)B * Sq * Hq;
  wide_dq_kernel<DK><<<(unsigned)((qrows + 7) / 8), 256, 0, st>>>(
      acc, static_cast<bf*>(dq), Sq, Hq, scale, qrows);
  if (split > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long krows = (long long)B * Sk * Hkv;
    wide_sum_kernel<DK, DV><<<(unsigned)((krows + 7) / 8), 256, 0, st>>>(
        part, static_cast<bf*>(dk), static_cast<bf*>(dv), B, Sk, Hkv, split,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch is the caller's f32 scratch of flash_prefill_bwd_scratch_floats
// values at the same split; every other pointer is a contiguous tensor as
// described above. Square calls (causal or windowed, Sq = Sk) or FULL
// (neither, any Sq, Sk); (dk, dv) = (d, d) for d 32/64/128 (bwd_kernel,
// split 1) or 256, or (192, 128) (wide_kernel, split from
// flash_prefill_bwd_split).
extern "C" int flash_prefill_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int dk_, int dv_,
    int causal, int window, int split, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv || window < 0 ||
      (Sq != Sk && (causal || window)) ||
      (split != 1 && !wide_widths(dk_, dv_)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_ARGS                                                     \
  q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, \
      window
  if (dk_ == dv_) {
    switch (dk_) {
      case 32: return dispatch<32>(REPRO_BWD_ARGS, scale, s);
      case 64: return dispatch<64>(REPRO_BWD_ARGS, scale, s);
      case 128: return dispatch<128>(REPRO_BWD_ARGS, scale, s);
      case 256:
        return launch_wide<256, 256>(REPRO_BWD_ARGS, split, scale, s);
    }
  } else if (dk_ == 192 && dv_ == 128) {
    return launch_wide<192, 128>(REPRO_BWD_ARGS, split, scale, s);
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// the head groups a call at these shapes splits each kv head's q heads
// into on a card of ``sms`` SMs (1 but at d 256 / (192, 128))
extern "C" int flash_prefill_bwd_split(int B, int Sk, int Hq, int Hkv, int dk,
                                       int dv, int sms) {
  return wide_split(B, Sk, Hq, Hkv, dk, dv, sms);
}

// the f32 values of the scratch a call at these shapes and split takes
extern "C" long long flash_prefill_bwd_scratch_floats(int B, int Sq, int Sk,
                                                      int Hq, int Hkv, int dk,
                                                      int dv, int split) {
  return scratch_floats(B, Sq, Sk, Hq, Hkv, dk, dv, split);
}

// the dynamic shared memory one CTA of the dK / dV / dQ kernel takes at
// (dk, dv) (bwd_kernel; wide_kernel at d 256 and (192, 128))
extern "C" int flash_prefill_bwd_smem_bytes(int dk, int dv) {
  if (dk == dv) {
    switch (dk) {
      case 32: return Tile<32>::SMEM;
      case 64: return Tile<64>::SMEM;
      case 128: return Tile<128>::SMEM;
      case 256: return Wide<256, 256>::SMEM;
    }
  } else if (dk == 192 && dv == 128) {
    return Wide<192, 128>::SMEM;
  }
  return 0;
}

REPRO_EXPORT_ERROR_STRING
