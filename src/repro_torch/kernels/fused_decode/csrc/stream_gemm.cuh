// The skinny product at the core of the port's decode-step kernels on
// Hopper (sm_90a), the FFN's passes and the QKV projection: out (B lanes x
// N) = A (B x K) @ W (K x N, row-major bf16), W streamed once from device
// memory, each pass's epilogue (a Pass policy) applied to the finished
// 64-column tiles, or to a whole column group at once.
//
// Bound: the weight bytes. At B = 8 each weight byte feeds 8 multiply-adds,
// about 1/70 of the card's bf16 rate, so the design is about keeping the
// memory streaming on every SM and spending few instructions per byte.
//
//  * Units. W is cut into units of 16 KB: TW adjacent 64-column tiles (a
//    column group; TW = 2, 128 columns, except the QKV pass at head_dim
//    256, whose group of four tiles holds a whole head) x 64 weight rows
//    (32 rows where a unit carries two weights, gate/up's, or four tiles).
//    A pass may take its tiles from up to three weights (Pass::source):
//    the QKV pass reads wq, wk and wv as one virtual N. Unit u is (group
//    u / kblocks, k-block u % kblocks). A persistent grid of one CTA per
//    SM (Plan.ctas = min(SMs, units)) gives CTA c the units [c U / ctas,
//    (c + 1) U / ctas): every CTA streams within one unit of the mean, and
//    a CTA's run covers a few groups, each over a contiguous range of
//    k-blocks (a segment).
//    stream_plan in fused_decode/ops.py is the same arithmetic, tested on
//    the host. Two tiles whose rows are read back to back: the H100
//    streams 256 bytes of each row markedly faster than a 64-column strip's
//    128 (tools/tma_stream_bench.cu measures both).
//  * A TMA ring. One producer thread keeps ~96 KB of units in flight in an
//    mbarrier-guarded ring: per unit the weight tiles (128-byte rows,
//    128-byte swizzle) and the activation tile of its 64-row k-block. The
//    activation is a bf16 matrix in device memory with k contiguous: the
//    pass's input (exact in bf16) or, for an f32 input, its hi / lo bf16
//    pair (hi = bf16(a), lo = bf16(a - hi), 2 NL rows), which the previous
//    pass's epilogue wrote. The ring is sized so that a CTA of the next pass
//    fits on the SM beside it (below).
//  * Tensor cores. A weight tile is wgmma's A (M = 64 columns, read
//    MN-major: the transpose bit), the lanes are its N: one m64nNk16 per 16
//    weight rows and tile, N = NL lanes (exact input) or 2 NL (hi | lo).
//    hi + lo is summed in f32, so the products carry ~2^-16 relative error,
//    as the JAX kernel's f32 arithmetic does; the doubled tensor work is
//    free at this intensity. One consumer warpgroup per CTA.
//  * A deterministic fix-up. A column group split over several CTAs is
//    finished by its first owner, whose run ends inside it. Every later
//    split sits at the start of its CTA's run: it stores its partial (128
//    threads x its fragment, coalesced) in slot (group, c - first owner)
//    and a lane of the producer warp publishes it (a release add to the
//    group's counter) while the consumers stream on, so no fix-up stalls
//    a stream in the middle. At its run's end the first owner waits for
//    the counter, resets it for the next call, and sums the partials in
//    split order after its own. No atomics touch values, so two calls
//    agree bit for bit. Then Pass::finish applies the epilogue to each
//    tile.
//  * Programmatic dependent launch. Every CTA lets the next kernel on the
//    stream launch at once, and that kernel's CTAs come up beside this
//    one's. Their producers load SG_EARLY units of weights, which depend on
//    nothing, before griddep_wait; the activation, partial sums, counters
//    and epilogue inputs only after it.
//
// Measured and left out (PERF.md): a pipelined consumer (wgmma_wait<1>),
// a deeper early load, L2 prefetch of the next pass's units by CTAs that
// have issued their own last load, and holding a segment that ends inside
// a run to fix it up with the run's last one: each was slower or no faster.
//
// Where it can go wrong, and what guards it: a wrong mbarrier phase hangs
// the CTA (run new work under a timeout); the weight and activation boxes'
// swizzle must match the wgmma descriptors (128-byte rows, 1024-byte 8-row
// groups) - the card tests hold every pass to its plain version at several
// shapes, lane counts and ragged edges; every global load a consumer
// thread has in flight holds up its next wgmma.fence, so the epilogue's
// inputs are loaded only once a segment's products are done.
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "tensor_map.cuh"

namespace repro {

using bf16 = __nv_bfloat16;

constexpr int SG_NT = 64;                  // columns per tile: wgmma's M
constexpr int SG_TW = 2;                   // adjacent tiles per unit
constexpr int SG_GROUP = SG_NT * SG_TW;    // columns per unit
constexpr int SG_CONSUMERS = 128;          // one warpgroup
constexpr int SG_THREADS = SG_CONSUMERS + 32;     // + the producer warp
constexpr int SG_RING = 96 * 1024;
constexpr int SG_SPLIT_LOADS = 8;          // partial sums in flight at once
// units a CTA loads before the kernel ahead of it on the stream has
// finished: few, since a co-resident CTA's loads queue ahead of the small
// ones (partial sums, epilogue inputs, the next activation) that that
// kernel's last CTAs and this one's first product wait on
constexpr int SG_EARLY = 2;
constexpr int SG_UNIT_BYTES = 16 * 1024;   // weight bytes per unit

// Weight rows per unit of a pass with nw weights and tw tiles a group: 16
// KB of weights each.
__host__ __device__ constexpr int unit_rows(int nw, int tw = SG_TW) {
  return SG_UNIT_BYTES / (nw * tw * SG_NT * 2);
}

// Where a pass's weight tile comes from: the tensor map (0-2) and its
// column.
struct TileSrc {
  int map, col;
};

// The units of one K x N product over `ctas` CTAs (see the top of the
// file): `groups` column groups of 64 TW, `kblocks` blocks of unit_rows
// rows.
struct Plan {
  int kblocks, groups, ctas, max_splits, cols;
  __device__ int units() const { return kblocks * groups; }
  __device__ int first(int c) const {
    return static_cast<int>(static_cast<long long>(c) * units() / ctas);
  }
  // the CTA whose run holds unit u
  __device__ int owner(int u) const {
    return static_cast<int>((static_cast<long long>(u + 1) * ctas - 1) /
                            units());
  }
};

// The ring of a pass: STAGES units, each NW x P::TW weight tiles of KB rows
// (each 64 columns of 128 bytes, swizzled) and the activation tile of the
// 64-row k-block that holds them (AR rows of 64 k), 1024-byte aligned.
template <class P>
struct Ring {
  static constexpr int KB = unit_rows(P::NW, P::TW);
  static constexpr int TILE = KB * SG_NT * 2;
  static constexpr int A_BYTES = P::AR * 128;
  static constexpr int STAGE = P::NW * P::TW * TILE + A_BYTES;
  static constexpr int STAGES = SG_RING / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES + 8;
  static_assert(A_BYTES % 1024 == 0 && TILE % 1024 == 0 && 64 % KB == 0,
                "tiles of whole 8-row groups; a unit inside one k-block");
};

// out tile of lanes: the consumer thread's fragment value q (of NL / 2) is
// output column 16 warp + g + 8 (q % 4 / 2) of the tile, lane
// 8 (q / 4) + 2 tig + q % 2 (wgmma's accumulator layout)
struct Frag {
  int warp, g, tig;
  __device__ int row(int q) const { return 16 * warp + g + 8 * ((q & 3) >> 1); }
  __device__ int lane(int q) const { return 8 * (q >> 2) + 2 * tig + (q & 1); }
};

// A CTA's partial sums reach the first owner of their column group so: the
// consumer threads store them, each warp's lane 0 arrives on an mbarrier,
// and one thread that waited on it adds 1 to the group's counter with
// release semantics at device scope; the first owner's thread 0 reads the
// counter with acquire semantics, then its threads read the partials.
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\nred.release.gpu.global.add.s32 [%0], %1;\n"
               ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// hi = bf16(a) at row b, lo = bf16(a - hi) at row nl + b of a (2 nl, width)
// bf16 matrix, column n: the activation of a pass that splits its input
__device__ __forceinline__ void store_hi_lo(__nv_bfloat16* img, int width,
                                            int nl, int b, int n, float a) {
  const __nv_bfloat16 hi = __float2bfloat16(a);
  img[(size_t)b * width + n] = hi;
  img[(size_t)(nl + b) * width + n] =
      __float2bfloat16(a - __bfloat162float(hi));
}

// A Pass P provides: NW (weights per unit), NL (lanes), AR (activation
// rows: NL, or 2 NL for a hi / lo input), SPLIT (AR == 2 NL), a Shared
// struct, setup(Shared&) (all consumer threads, before the first
// epilogue), a struct In and load(tile, Frag, In&) (the epilogue's inputs
// from device memory, loaded as the tile's fix-up starts, so their latency
// hides under it: not earlier, since each unit's wgmma.fence waits for
// every load in flight), and finish(tile, v, In, Shared&, Frag) with
// v[NW][NL / 2] the finished sums of 64-column tile `tile`. load and finish
// are called for each tile that starts inside the N columns. Besides: TW
// (tiles a column group, SG_TW but for the QKV pass at head_dim 256);
// MAPPED, where the pass gives source(tile) (the weight map and its
// column; else tile t of weight j is column 64 t of map j); and
// GROUP_EPILOGUE, where finish_group(group, v[TW][NL / 2], Shared&, Frag)
// takes the place of load and finish.
template <class P>
__global__ void __launch_bounds__(SG_THREADS, 1)
stream_kernel(const __grid_constant__ CUtensorMap w0,
              const __grid_constant__ CUtensorMap w1,
              const __grid_constant__ CUtensorMap w2,
              const __grid_constant__ CUtensorMap act, const Plan plan,
              float* __restrict__ partial, int* __restrict__ counters,
              const P p) {
  using R = Ring<P>;
  constexpr int NW = P::NW, AR = P::AR, NV = P::NL / 2, KB = R::KB;
  constexpr int TW = P::TW;
  constexpr int NT = NW * TW;              // weight tiles per unit
  static_assert(AR == (P::SPLIT ? 2 : 1) * P::NL && NV % 4 == 0, "lanes");
  extern __shared__ unsigned char smem_raw[];
  __shared__ typename P::Shared sh;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + R::STAGES * R::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (R::STAGES + s); };
  const uint32_t handed = bars + 16 * R::STAGES;   // partials stored
  const int c = blockIdx.x, u_lo = plan.first(c), u_hi = plan.first(c + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), SG_CONSUMERS / 32);
    }
    mbar_init(handed, SG_CONSUMERS / 32);
    mbar_fence_init();
  }
  __syncthreads();
  griddep_launch_dependents();

  if (warp == SG_CONSUMERS / 32) {
    if (lane == 1 && u_lo % plan.kblocks) {
      // A run that starts inside a column group hands that group's partial
      // sums to its first owner (a CTA before this one): lane 1 publishes
      // them once stored, so the consumers stream on meanwhile. (In a
      // branch apart from lane 0's: where the two met again, lane 0 would
      // wait for this lane before issuing the loads the consumers need.)
      mbar_wait(handed, 0);
      red_release_add(counters + u_lo / plan.kblocks, 1);
      return;
    }
    // ------------------------------------------------------- producer
    if (lane != 0) return;
    tma_prefetch_map(&w0);
    if (NW == 2 || P::MAPPED) tma_prefetch_map(&w1);
    if (P::MAPPED) tma_prefetch_map(&w2);
    tma_prefetch_map(&act);
    // the unit's tiles, those of a weight back to back: they share rows
    auto load_w = [&](int i) {
      const int u = u_lo + i, s = i % R::STAGES;
      const uint32_t st = base + s * R::STAGE;
      const int t0 = (u / plan.kblocks) * TW;
      const int k0 = (u % plan.kblocks) * KB;
      mbar_expect_tx(full(s), R::STAGE);
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int h = 0; h < TW; ++h) {
          TileSrc src{j, (t0 + h) * SG_NT};
          if constexpr (P::MAPPED) src = p.source(t0 + h);
          tma_load_2d(st + (j * TW + h) * R::TILE,
                      src.map == 0 ? &w0 : src.map == 1 ? &w1 : &w2,
                      full(s), src.col, k0);
        }
    };
    auto load_a = [&](int i) {
      const int u = u_lo + i, s = i % R::STAGES;
      tma_load_2d(base + s * R::STAGE + NT * R::TILE, &act, full(s),
                  (u % plan.kblocks) * KB / 64 * 64, 0);
    };
    const int n = u_hi - u_lo, pre = min(n, R::STAGES);
    const int early = min(pre, SG_EARLY);
    for (int i = 0; i < early; ++i) load_w(i);   // weights wait for nothing
    griddep_wait();
    for (int i = 0; i < early; ++i) load_a(i);
    for (int i = early; i < pre; ++i) {
      load_w(i);
      load_a(i);
    }
    for (int i = pre; i < n; ++i) {
      mbar_wait(empty(i % R::STAGES), ((i / R::STAGES) & 1) ^ 1);
      load_w(i);
      load_a(i);
    }
    return;
  }

  // --------------------------------------------------------- consumers
  griddep_wait();
  const Frag fr{warp, lane >> 2, lane & 3};
  // both operands: 128-byte rows, 8-row groups 1024 bytes apart
  constexpr uint32_t HI = desc_hi(1024, 128);
  float acc[NT][AR / 2] = {};
  bool set_up = false;

  // A segment's end. In a run that starts inside column group grp this
  // CTA's partial sums go to the group's first owner (the CTA whose run
  // holds its first unit, and ends inside it): stored, handed to lane 1,
  // and the consumers go on. The first owner, at its run's end, waits for
  // the group's other splits, sums them in split order after its own, and
  // resets the counter for the next call; a CTA holding a whole group
  // finishes it at once. Then the epilogue, tile by tile.
  auto end_segment = [&](int grp, float (&v)[NT][NV]) {
    const int c0 = plan.owner(grp * plan.kblocks);
    const int splits =
        plan.owner(grp * plan.kblocks + plan.kblocks - 1) - c0 + 1;
    constexpr int NF = NT * NV;
    auto slot = [&](int sp) {
      return reinterpret_cast<float4*>(
          partial + ((size_t)(grp * plan.max_splits + sp) * SG_CONSUMERS +
                     threadIdx.x) * NF);
    };
    if (c != c0) {
      float4* mine = slot(c - c0);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < NV; q += 4)
          mine[(j * NV + q) / 4] =
              make_float4(v[j][q], v[j][q + 1], v[j][q + 2], v[j][q + 3]);
      __syncwarp();
      if (lane == 0) mbar_arrive(handed);
      return;
    }
    if (!set_up) {
      p.setup(sh);
      set_up = true;
    }
    auto live = [&](int h) { return (grp * TW + h) * SG_NT < plan.cols; };
    typename P::In in[TW];         // in flight under the wait and the sum
    if constexpr (!P::GROUP_EPILOGUE) {
#pragma unroll
      for (int h = 0; h < TW; ++h)
        if (live(h)) p.load(grp * TW + h, fr, in[h]);
    }
    if (splits > 1) {
      if (threadIdx.x == 0) {
        while (ld_acquire(counters + grp) != splits - 1) {
        }
        counters[grp] = 0;         // ready for the next call
      }
      named_sync(1, SG_CONSUMERS);
      // the other splits in split order, up to SG_SPLIT_LOADS loads in
      // flight together
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < NV; q += 4) {
          float4 sum = make_float4(v[j][q], v[j][q + 1], v[j][q + 2],
                                   v[j][q + 3]);
          for (int sp0 = 1; sp0 < splits; sp0 += SG_SPLIT_LOADS) {
            float4 w[SG_SPLIT_LOADS];
#pragma unroll
            for (int k = 0; k < SG_SPLIT_LOADS; ++k)
              if (sp0 + k < splits)
                w[k] = __ldcg(slot(sp0 + k) + (j * NV + q) / 4);
#pragma unroll
            for (int k = 0; k < SG_SPLIT_LOADS; ++k)
              if (sp0 + k < splits) {
                sum.x += w[k].x;
                sum.y += w[k].y;
                sum.z += w[k].z;
                sum.w += w[k].w;
              }
          }
          v[j][q] = sum.x;
          v[j][q + 1] = sum.y;
          v[j][q + 2] = sum.z;
          v[j][q + 3] = sum.w;
        }
    }
    if constexpr (P::GROUP_EPILOGUE) {
      p.finish_group(grp, v, sh, fr);
    } else {
#pragma unroll
      for (int h = 0; h < TW; ++h) {
        if (!live(h)) break;
        float vt[NW][NV];
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int q = 0; q < NV; ++q) vt[j][q] = v[j * TW + h][q];
        p.finish(grp * TW + h, vt, in[h], sh, fr);
      }
    }
  };

  int i = 0;                       // the CTA's units consumed so far
  for (int u = u_lo; u < u_hi;) {
    const int grp = u / plan.kblocks;
    const int end = min(u_hi, (grp + 1) * plan.kblocks);
    for (int first = 1; u < end; ++u, ++i, first = 0) {
      const int s = i % R::STAGES;
      mbar_wait(full(s), (i / R::STAGES) & 1);
      const uint32_t st = base + s * R::STAGE;
      // the unit's rows start (u % kblocks) * KB % 64 rows into the
      // activation's k-block: 16 rows (32 bytes) a k-step
      const uint32_t xd = desc_lo(st + NT * R::TILE, 16) +
                          (((u % plan.kblocks) * KB % 64) * 2 >> 4);
#pragma unroll
      for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          wgmma_ss_ta<AR>(
              acc[j],
              make_desc(desc_lo(st + j * R::TILE + kk * 16 * 128, R::TILE),
                        HI),
              make_desc(xd + ((kk * 32) >> 4), HI), !first || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // the segment's sums: hi + lo columns where the input was split
    float v[NT][NV];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        if constexpr (P::SPLIT)
          v[j][q] = acc[j][q] + acc[j][q + NV];
        else
          v[j][q] = acc[j][q];
      }
    end_segment(grp, v);
  }
}

// Launches one pass on `plan.ctas` CTAs with programmatic stream
// serialisation; w1 and w2 are read only by a pass that names them. The
// dynamic shared memory opt-in is set once per device. Static: each kernel
// library keeps its own record of the opt-in (an inline function's static
// would be one object for every library loaded in the process, and a
// second library's kernel would launch without it).
template <class P>
static int launch_stream(const CUtensorMap& w0, const CUtensorMap& w1,
                         const CUtensorMap& w2, const CUtensorMap& act,
                         const Plan& plan, float* partial, int* counters,
                         const P& p, cudaStream_t stream) {
  static unsigned opted = 0;                 // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(__atomic_load_n(&opted, __ATOMIC_ACQUIRE) >> dev & 1u)) {
    e = cudaFuncSetAttribute(stream_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<P>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    __atomic_fetch_or(&opted, 1u << dev, __ATOMIC_RELEASE);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.ctas);
  cfg.blockDim = dim3(SG_THREADS);
  cfg.dynamicSmemBytes = Ring<P>::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, stream_kernel<P>, w0, w1, w2, act, plan,
                         partial, counters, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// a row-major (rows, cols) bf16 matrix read in boxes of 64 columns x
// box_rows rows
inline bool map_rows(CUtensorMap* m, const void* p, long long rows,
                     long long cols, int box_rows) {
  return map_2d_bf16(m, p, cols, rows, cols * 2, SG_NT, box_rows);
}

// the workspace region at byte offset pl[f] of a wrapper's int64 plan
template <class T>
T* at(void* ws, const long long* pl, int f) {
  return reinterpret_cast<T*>(static_cast<char*>(ws) + pl[f]);
}

// Calls f(NL) with NL as a std::integral_constant for the lane counts the
// kernels are built for; others are refused.
template <class Fn>
int with_lanes(long long nl, Fn&& f) {
  switch (nl) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro
