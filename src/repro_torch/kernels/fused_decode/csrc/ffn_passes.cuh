// The passes of the port's FFN kernels on Hopper (sm_90a), each a
// stream_gemm.cuh weight stream with its own epilogue:
//
//   OprojPass   y = x + attn @ Wo; per 64-column tile and lane sum(y^2);
//               the gate/up activation y * scale as a hi / lo bf16 pair
//   GateUpPass  g, u = rstd * ((y * scale) @ Wg, (y * scale) @ Wu), rstd
//               per lane from the tiles' squares; h = silu(g) * u as the
//               down-projection's hi / lo pair
//   DownPass    out = [y +] h @ Wd, cast to bf16
//
// RMSNorm(y) @ W = rstd * ((y * scale) @ W): rstd is a per-lane factor, so
// it is applied to the finished sums and the activation needs no pass over
// all of y first. oproj_ffn_swiglu.cu runs o-proj, gate/up, down;
// ffn_swiglu.cu runs rms_prep.cuh's first pass (x's squares and x * scale),
// then gate/up, down. Three launches each, chained by programmatic
// dependent launch.
#pragma once

#include "rms_prep.cuh"

namespace repro {

template <int NL_>
struct OprojPass {
  static constexpr int NW = 1, NL = NL_, AR = NL_;
  static constexpr bool SPLIT = false;        // attn is exact in bf16
  static constexpr int TW = SG_TW;
  static constexpr bool MAPPED = false, GROUP_EPILOGUE = false;
  struct Shared { float red[4][NL_]; };
  const bf16* x;
  const bf16* scale;
  float* y;             // (B, D) f32
  float* ss;            // (B, tiles) per-tile sums of y^2
  bf16* img;            // (2 NL, D): y * scale, hi | lo
  int B, D, tiles;

  struct In { float x[NL_ / 2], scale[2]; };   // scale of rows g, g + 8

  __device__ void setup(Shared&) const {}

  __device__ void load(int t, const Frag& fr, In& in) const {
#pragma unroll
    for (int q = 0; q < NL_ / 2; ++q) {
      const int n = t * SG_NT + fr.row(q), b = fr.lane(q);
      in.x[q] = n < D && b < B ? to_f(x[(size_t)b * D + n]) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = t * SG_NT + fr.row(2 * h);
      in.scale[h] = n < D ? to_f(scale[n]) : 0.f;
    }
  }

  __device__ void finish(int t, const float (&v)[1][NL_ / 2], const In& in,
                         Shared& sh, const Frag& fr) const {
    float sq[NL_ / 8][2] = {};
#pragma unroll
    for (int q = 0; q < NL_ / 2; ++q) {
      const int n = t * SG_NT + fr.row(q), b = fr.lane(q);
      if (n < D && b < B) {
        const float yv = in.x[q] + v[0][q];
        y[(size_t)b * D + n] = yv;
        store_hi_lo(img, D, NL_, b, n, yv * in.scale[(q & 3) >> 1]);
        sq[q >> 2][q & 1] += yv * yv;
      }
    }
    // lane b's sum over the tile: the 8 rows g of each warp, then the warps
#pragma unroll
    for (int jj = 0; jj < NL_ / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = sq[jj][h];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (fr.g == 0) sh.red[fr.warp][8 * jj + 2 * fr.tig + h] = s;
      }
    named_sync(1, SG_CONSUMERS);
    const int b = threadIdx.x;
    if (b < NL_ && b < B)
      ss[(size_t)b * tiles + t] =
          ((sh.red[0][b] + sh.red[1][b]) + sh.red[2][b]) + sh.red[3][b];
    named_sync(1, SG_CONSUMERS);
  }
};

template <int NL_>
struct GateUpPass {
  static constexpr int NW = 2, NL = NL_, AR = 2 * NL_;
  static constexpr bool SPLIT = true;
  static constexpr int TW = SG_TW;
  static constexpr bool MAPPED = false, GROUP_EPILOGUE = false;
  struct Shared { float rstd[NL_]; };
  const float* ss;      // (B, tiles_d) per-tile sums of y^2
  bf16* img;            // (2 NL, F): h, hi | lo
  int B, D, F, tiles_d;

  __device__ void setup(Shared& sh) const {
    lanes_rstd<NL_>(ss, B, D, tiles_d, sh.rstd);
  }

  struct In {};
  __device__ void load(int, const Frag&, In&) const {}

  __device__ void finish(int t, const float (&v)[2][NL_ / 2], const In&,
                         Shared& sh, const Frag& fr) const {
#pragma unroll
    for (int q = 0; q < NL_ / 2; ++q) {
      const int f = t * SG_NT + fr.row(q), b = fr.lane(q);
      if (f < F && b < B) {
        const float g = v[0][q] * sh.rstd[b], u = v[1][q] * sh.rstd[b];
        store_hi_lo(img, F, NL_, b, f, g / (1.f + expf(-g)) * u);
      }
    }
  }
};

template <int NL_>
struct DownPass {
  static constexpr int NW = 1, NL = NL_, AR = 2 * NL_;
  static constexpr bool SPLIT = true;
  static constexpr int TW = SG_TW;
  static constexpr bool MAPPED = false, GROUP_EPILOGUE = false;
  struct Shared {};
  bf16* out;            // (B, D)
  const float* y;       // residual in f32, or nullptr
  const bf16* x;        // residual in bf16, or nullptr
  int B, D;

  struct In { float r[NL_ / 2]; };               // the residual

  __device__ void setup(Shared&) const {}

  __device__ void load(int t, const Frag& fr, In& in) const {
#pragma unroll
    for (int q = 0; q < NL_ / 2; ++q) {
      const int n = t * SG_NT + fr.row(q), b = fr.lane(q);
      const size_t i = (size_t)b * D + n;
      in.r[q] = !(n < D && b < B) ? 0.f
                : y ? __ldcg(y + i) : x ? to_f(x[i]) : 0.f;
    }
  }

  __device__ void finish(int t, const float (&v)[1][NL_ / 2], const In& in,
                         Shared&, const Frag& fr) const {
#pragma unroll
    for (int q = 0; q < NL_ / 2; ++q) {
      const int n = t * SG_NT + fr.row(q), b = fr.lane(q);
      if (n < D && b < B)
        out[(size_t)b * D + n] = __float2bfloat16(in.r[q] + v[0][q]);
    }
  }
};

// The wrapper's plan of one call, an array of int64 in this order
// (fused_decode/ops.py::_PLAN_FIELDS): shapes, each pass's CTAs and most
// splits of a column tile, then byte offsets into the workspace (counters
// first, zeroed once and reset by the kernels).
enum PlanField {
  PL_B, PL_D, PL_HD, PL_F, PL_NL,
  PL_CTAS_O, PL_MAXS_O, PL_CTAS_GU, PL_MAXS_GU, PL_CTAS_DN, PL_MAXS_DN,
  PL_Y, PL_SS, PL_IMG_G, PL_IMG_D, PL_PART_O, PL_PART_GU, PL_PART_DN,
  PL_CNT_O, PL_CNT_GU, PL_CNT_DN, PL_LEN
};

// the plan of a K x N weight stream with nw weights per unit
inline Plan plan_of(const long long* pl, int k, int n, int nw, PlanField ctas,
                    PlanField maxs) {
  const int kb = unit_rows(nw);
  return Plan{(k + kb - 1) / kb, (n + SG_GROUP - 1) / SG_GROUP,
              static_cast<int>(pl[ctas]), static_cast<int>(pl[maxs]), n};
}

// The gate/up and down weight streams of one call: their maps and plans.
template <int NL>
struct FfnStreams {
  CUtensorMap wg, wu, wd, act_g, act_d;
  Plan gu, dn;

  // false where a map cannot be made
  bool init(const long long* pl, void* ws, const void* wg_, const void* wu_,
            const void* wd_) {
    const int D = pl[PL_D], F = pl[PL_F];
    gu = plan_of(pl, D, F, 2, PL_CTAS_GU, PL_MAXS_GU);
    dn = plan_of(pl, F, D, 1, PL_CTAS_DN, PL_MAXS_DN);
    return map_rows(&wg, wg_, D, F, unit_rows(2)) &&
           map_rows(&wu, wu_, D, F, unit_rows(2)) &&
           map_rows(&wd, wd_, F, D, unit_rows(1)) &&
           map_rows(&act_g, at<bf16>(ws, pl, PL_IMG_G), 2 * NL, D, 2 * NL) &&
           map_rows(&act_d, at<bf16>(ws, pl, PL_IMG_D), 2 * NL, F, 2 * NL);
  }

  // gate/up then down, after a first pass that left the per-tile squares in
  // ss and the hi / lo activation in img_g; residual y (f32) or x (bf16)
  // or neither
  int launch(const long long* pl, void* ws, void* out, const float* y,
             const bf16* x, cudaStream_t s) const {
    const int B = pl[PL_B], D = pl[PL_D], F = pl[PL_F];
    const GateUpPass<NL> pg{at<float>(ws, pl, PL_SS),
                            at<bf16>(ws, pl, PL_IMG_D), B, D, F,
                            (D + SG_NT - 1) / SG_NT};
    int rc = launch_stream(wg, wu, wu, act_g, gu,
                           at<float>(ws, pl, PL_PART_GU),
                           at<int>(ws, pl, PL_CNT_GU), pg, s);
    if (rc) return rc;
    const DownPass<NL> pd{static_cast<bf16*>(out), y, x, B, D};
    return launch_stream(wd, wd, wd, act_d, dn,
                         at<float>(ws, pl, PL_PART_DN),
                         at<int>(ws, pl, PL_CNT_DN), pd, s);
  }
};

}  // namespace repro

// The dynamic shared memory of one CTA of pass `pass` (0 o-proj, 1 gate/up,
// 2 down) at `nl` lanes, 0 for another: for the build report.
extern "C" int stream_smem_bytes(int pass, int nl) {
  using namespace repro;
  if (nl != 8 && nl != 16) return 0;
  return with_lanes(nl, [&](auto L) {
    constexpr int N = decltype(L)::value;
    return pass == 0 ? Ring<OprojPass<N>>::SMEM
         : pass == 1 ? Ring<GateUpPass<N>>::SMEM
         : pass == 2 ? Ring<DownPass<N>>::SMEM : 0;
  });
}
