// The QKV projection of the port's decode steps on Hopper (sm_90a), shared
// by qkv_rope_paged.cu (native wq / wk / wv, a position per lane) and
// qkv_rope.cu (one concatenated w_qkv, a position shared by the batch,
// partial rotation). What differs - where a column's weights sit, each
// lane's position, where an output goes - is the output functor.
//
// Computes, for decode lanes x (B, D): xn = x * rsqrt(mean(x^2) + 1e-6) *
// scale (f32), per head y = xn @ W_head, and rotates the q and k heads: the
// first 2 * rot2 elements of a head by the lane's position with the
// host-computed inverse frequencies inv_freq (rot2,) f32; the rest of the
// head, and every v head, pass through unrotated.
//
// Bound: device-memory bytes. The weights are D * (Hq + 2 Hkv) * dh
// elements, read once; at B = 8 the arithmetic is 2 * B flops per weight,
// far below the card's flop-to-byte ratio.
//
// Design: two launches per 16 lanes, chained by programmatic dependent
// launch. rms_prep.cuh's first pass writes each lane's per-tile squares
// and x * scale as a hi / lo bf16 pair; then one stream_gemm.cuh weight
// stream over all Hq + 2 Hkv heads (QkvPass), whose producers load their
// first weights while the first pass, and the kernel ahead of it, run.
//  * One virtual N. The columns of wq, then wk, then wv, each weight's
//    start rounded up to a whole 64-column tile where they are separate
//    tensors (source(): a tile's map and column; TMA zero-fills columns
//    past a weight's edge, and those are never written), or w_qkv's own
//    columns.
//  * RoPE pairs element e of a head with e + rot2, so a head must end in
//    the CTA that finishes its column group. Every head starts at a
//    multiple of dh in its weight's columns and every weight at a tile, so
//    a head of dh <= 64 lies in one tile and one of 128 in one group of
//    two; at dh = 256 the group is four tiles (TW = 4, 32 weight rows a
//    unit, still 16 KB). The finishing CTA stages the group's finished
//    sums, times the lane's rstd, in shared memory (NL x 64 TW f32), and
//    its threads read both partners from there: one code path for every
//    dh and rot2.
//  * The epilogue's inputs (rstd from the squares, the positions, inv_freq)
//    are loaded in setup, once a segment's products are done.
#pragma once

#include "rms_prep.cuh"

namespace repro {

// The wrapper's plan of one call, an array of int64 in this order
// (fused_decode/ops.py::_QKV_PLAN_FIELDS): shapes, the virtual columns
// (k's and v's first, all of them), the stream's CTAs and most splits of a
// column group, then byte offsets into the workspace (counters first,
// zeroed once and reset by the kernel).
enum QkvPlanField {
  QP_B, QP_D, QP_HQ, QP_HKV, QP_DH, QP_ROT2, QP_NL, QP_TW, QP_K0, QP_V0,
  QP_COLS, QP_CTAS, QP_MAXS, QP_SS, QP_IMG, QP_PART, QP_CNT, QP_LEN
};

// q (B, Hq, dh), k / v (B, Hkv, dh) from three weights, a position per lane
struct SplitOut {
  static constexpr bool SEPARATE = true;       // three weight maps
  bf16 *q, *k, *v;
  const int* pos_b;
  int wq, wkv;                                 // Hq * dh, Hkv * dh
  __device__ int pos(int b) const { return pos_b[b]; }
  // elements nl, nl + 1 of weight s's columns (0 q, 1 k, 2 v), lane b
  __device__ void store(int s, int b, int nl, float o0, float o1) const {
    bf16* row = s == 0 ? q + (size_t)b * wq
                       : (s == 1 ? k : v) + (size_t)b * wkv;
    *reinterpret_cast<__nv_bfloat162*>(row + nl) =
        __floats2bfloat162_rn(o0, o1);
  }
};

// out (H, lanes, dh), head-major, from one w_qkv, one position for every
// lane; this call's lanes start at lane0
struct HeadMajorOut {
  static constexpr bool SEPARATE = false;
  bf16* o;
  int lanes, lane0, p, dh, hq, hkv;
  __device__ int pos(int) const { return p; }
  __device__ void store(int s, int b, int nl, float o0, float o1) const {
    const int hh = (s == 0 ? 0 : s == 1 ? hq : hq + hkv) + nl / dh;
    *reinterpret_cast<__nv_bfloat162*>(
        o + ((size_t)hh * lanes + lane0 + b) * dh + nl % dh) =
        __floats2bfloat162_rn(o0, o1);
  }
};

template <int NL_, int TW_, class Out>
struct QkvPass {
  static constexpr int NW = 1, NL = NL_, AR = 2 * NL_, TW = TW_;
  static constexpr bool SPLIT = true;            // x * scale as hi | lo
  static constexpr bool MAPPED = true, GROUP_EPILOGUE = true;
  static constexpr int GROUP = TW_ * SG_NT;
  struct Shared {
    float y[NL_][GROUP + 4];   // the group's sums times rstd (+4: no bank
                               // conflicts where fragments are stored)
    float rstd[NL_], inv[128];
    int pos[NL_];
  };
  const float* ss;             // (B, tiles_d) per-tile sums of x^2
  const float* inv_freq;       // (rot2,)
  Out out;
  int B, D, tiles_d, dh, rot2, k0, v0, wq, wkv;

  __device__ TileSrc source(int t) const {
    const int n = t * SG_NT;
    if (!Out::SEPARATE) return {0, n};
    return n < k0 ? TileSrc{0, n} : n < v0 ? TileSrc{1, n - k0}
                                           : TileSrc{2, n - v0};
  }

  __device__ void setup(Shared& sh) const {
    const int i = threadIdx.x;
    if (i < rot2) sh.inv[i] = inv_freq[i];
    if (i < NL_) sh.pos[i] = i < B ? out.pos(i) : 0;
    lanes_rstd<NL_>(ss, B, D, tiles_d, sh.rstd);   // ends at a barrier
  }

  struct In {};

  // The group's finished sums v: scaled by rstd into shared memory, then
  // two adjacent columns of one lane a thread, RoPE on q and k, cast, store.
  __device__ void finish_group(int grp, const float (&v)[TW_][NL_ / 2],
                               Shared& sh, const Frag& fr) const {
#pragma unroll
    for (int h = 0; h < TW_; ++h)
#pragma unroll
      for (int q = 0; q < NL_ / 2; ++q) {
        const int b = fr.lane(q);
        sh.y[b][h * SG_NT + fr.row(q)] = v[h][q] * sh.rstd[b];
      }
    named_sync(1, SG_CONSUMERS);
    for (int i = threadIdx.x; i < NL_ * GROUP / 2; i += SG_CONSUMERS) {
      const int b = i / (GROUP / 2), c = 2 * (i % (GROUP / 2));
      if (b >= B) break;
      const int n = grp * GROUP + c;
      const int s = n < k0 ? 0 : n < v0 ? 1 : 2;
      const int nl = n - (s == 0 ? 0 : s == 1 ? k0 : v0);
      if (nl >= (s == 0 ? wq : wkv)) continue;     // padding, or past N
      const int e = nl % dh;
      float o[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float y = sh.y[b][c + r];
        const int er = e + r;
        if (s < 2 && er < 2 * rot2) {
          const bool first = er < rot2;
          float sn, cs;
          sincosf((float)sh.pos[b] * sh.inv[first ? er : er - rot2], &sn,
                  &cs);
          o[r] = first ? y * cs - sh.y[b][c + r + rot2] * sn
                       : y * cs + sh.y[b][c + r - rot2] * sn;
        } else {
          o[r] = y;
        }
      }
      out.store(s, b, nl, o[0], o[1]);
    }
    named_sync(1, SG_CONSUMERS);             // y is the next group's
  }
};

// Calls f(TW) with TW as a std::integral_constant: 2 (dh <= 128) or 4 (dh
// 256); others are refused.
template <class Fn>
int with_group(long long tw, Fn&& f) {
  switch (tw) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The two launches of one call on at most 16 lanes: the first pass, then
// the weight stream. wk and wv are read only where Out::SEPARATE (else wq
// is w_qkv).
template <class Out>
int qkv_rope_launch(const long long* pl, const void* x, const void* scale,
                    const void* wq, const void* wk, const void* wv,
                    const void* inv_freq, const Out& out, void* ws,
                    cudaStream_t s) {
  return with_lanes(pl[QP_NL], [&](auto L) {
    constexpr int NL = decltype(L)::value;
    return with_group(pl[QP_TW], [&](auto T) {
      constexpr int TW = decltype(T)::value, G = TW * SG_NT;
      constexpr int KB = unit_rows(1, TW);
      const int B = pl[QP_B], D = pl[QP_D], dh = pl[QP_DH];
      const int wq_cols = pl[QP_HQ] * dh, wkv_cols = pl[QP_HKV] * dh;
      const int cols = pl[QP_COLS];
      CUtensorMap mq, mk, mv, act;
      bool ok = map_rows(&act, at<bf16>(ws, pl, QP_IMG), 2 * NL, D, 2 * NL);
      if (Out::SEPARATE) {
        ok = ok && map_rows(&mq, wq, D, wq_cols, KB) &&
             map_rows(&mk, wk, D, wkv_cols, KB) &&
             map_rows(&mv, wv, D, wkv_cols, KB);
      } else {
        ok = ok && map_rows(&mq, wq, D, cols, KB);
        mk = mv = mq;
      }
      if (!ok) return static_cast<int>(cudaErrorInvalidValue);
      float* ss = at<float>(ws, pl, QP_SS);
      const int rc = launch_rms_prep<NL>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(scale), ss,
          at<bf16>(ws, pl, QP_IMG), B, D, s);
      if (rc) return rc;
      const Plan plan{(D + KB - 1) / KB, (cols + G - 1) / G,
                      static_cast<int>(pl[QP_CTAS]),
                      static_cast<int>(pl[QP_MAXS]), cols};
      const QkvPass<NL, TW, Out> p{
          ss, static_cast<const float*>(inv_freq), out, B, D,
          (D + SG_NT - 1) / SG_NT, dh, static_cast<int>(pl[QP_ROT2]),
          static_cast<int>(pl[QP_K0]), static_cast<int>(pl[QP_V0]), wq_cols,
          wkv_cols};
      return launch_stream(mq, mk, mv, act, plan, at<float>(ws, pl, QP_PART),
                           at<int>(ws, pl, QP_CNT), p, s);
    });
  });
}

}  // namespace repro

// The dynamic shared memory of one CTA of the QKV stream at `nl` lanes and
// `tw` tiles a group, 0 for another: for the build report.
extern "C" int qkv_smem_bytes(int nl, int tw) {
  using namespace repro;
  if ((nl != 8 && nl != 16) || (tw != 2 && tw != 4)) return 0;
  return with_lanes(nl, [&](auto L) {
    return with_group(tw, [&](auto T) {
      return Ring<QkvPass<decltype(L)::value, decltype(T)::value,
                          SplitOut>>::SMEM;
    });
  });
}
