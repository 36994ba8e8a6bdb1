// The fused Monarch FFT-conv (paper Fig. 4, the FlashFFTConv structure) for
// Hopper (sm_90a): monarch, a pointwise filter, inverse monarch,
//
//     F  = bf16(W1 . A^T) (*) filt,   A = (W0 . x[b]) (*) tw
//     Bm = (W0i . F) (*) twi
//     Z[b] = W1i . Bm^T               x (B, N1, N2) -> Z (B, N1, N2)
//
// Replaces: src/repro/kernels/monarch_fft/kernel.py::monarch_conv_fused
// (_monarch_conv_kernel), reached through monarch_fft/ops.py::monarch_conv.
//
// Bound: tensor-core operations. Two Monarch passes plus the filter,
// 2 * 4 * B * N1 * N2 * (N1 + N2) / 2 + B * N1 * N2 flops, against x, the
// seven factors and Z read or written once: at (16, 1024, 1024) 1.37e11
// flops and 81.8 MB, 0.139 ms at 989 TFLOP/s.
//
// Design: TWO launches where the TPU kernel has one, because a 1M-point row
// (2 MB in bf16) does not fit the 227 KB of shared memory a CTA may have.
// ops.py::monarch_conv_plan picks one of two forms; both keep every
// rounding point of the oracle (monarch_conv_ref: each pass's twiddled
// intermediate and output rounded to bf16, the filter multiplying the
// rounded pass output) and sum in the same order.
//  * Two passes (N1 % 128 == 0, N1 <= 5888, a grid past one wave; the
//    1M-point shape): conv_forward_kernel is monarch.cu's pass with the
//    filter in its epilogue, F = bf16(bf16(W1 . A^T) (*) filt) written to
//    device memory (B, N2, N1); conv_inverse_kernel is the pass again on F
//    with W0i, twi, W1i, which writes Z. Each runs 64-row blocks at (16,
//    1024, 1024) (5 stages; 1.21 and 1.17 GB read from L2 a call, as
//    modelled).
//  * One front launch, then a GEMM (a grid within one wave, N1 % 128 ==
//    64, N1 past 5888): conv_front_kernel runs the three products that
//    are local to a block of BM rows of N1 (monarch_core.cuh, phases
//    1-3): A_blk, then F_blk = bf16(bf16(W1 . A_blk^T) (*) filt[:, blk])
//    kept K-major for phase 3, then Bm[:, blk] = bf16((W0i . F_blk) (*)
//    twi[:, blk]), written to device memory as Bm (B, N2, N1).
//    conv_back_kernel contracts across every block: Z[b] = W1i . Bm[b]^T,
//    a TMA / wgmma GEMM with both operands K-major (Bm's rows are the
//    product's columns: the transpose again an access pattern), 128 x 128
//    tiles, a 3-stage ring of 32 KB, two CTAs an SM. Holding A_blk and
//    F_blk together caps the front's blocks at 32 rows, so its products
//    are half as wide and it reads each streamed byte half as often as a
//    pass: at (16, 1024, 1024) it would take 512 CTAs in four waves and
//    3.36 GB of L2 reads, and the back GEMM 0.537 GB.
// The intermediate (F or Bm) costs 2 * B * N1 * N2 * 2 bytes of device
// traffic (64 MB at the 1M-point shape, 0.019 ms at 3.35 TB/s).
// ops.py::monarch_l2_bytes models each launch's L2 reads for any plan.
#include "monarch_core.cuh"

using namespace repro;
using namespace repro::monarch;

namespace {

template <int BM, int R>
__global__ void __launch_bounds__(THREADS, 1)
conv_front_kernel(const __grid_constant__ Maps mp, bf16* __restrict__ bm,
                  int N1, int N2, int S) {
  front<true, BM, R>(mp, bm, N1, N2, S);
}

// The two passes: F = bf16(bf16(monarch(x)) * filt) (B, N2, N1), then Z =
// monarch(F, W0i, twi, W1i), each the pass of monarch.cu
template <int BM, int R>
__global__ void __launch_bounds__(THREADS, 1)
conv_forward_kernel(const __grid_constant__ Maps mp, bf16* __restrict__ f,
                    int N1, int N2, int S) {
  front<false, BM, R>(mp, f, N1, N2, S, true);
}

template <int BM, int R>
__global__ void __launch_bounds__(THREADS, 1)
conv_inverse_kernel(const __grid_constant__ Maps mp, bf16* __restrict__ z,
                    int N1, int N2, int S) {
  front<false, BM, R>(mp, z, N1, N2, S);
}

constexpr int BACK_STAGES = 3;
constexpr int BACK_THREADS = CONSUMERS + 32;  // + a producer warp
constexpr int BACK_STAGE = 2 * A_STAGE;      // a W1i tile and a Bm tile
constexpr int BACK_SMEM = 1024 + BACK_STAGES * BACK_STAGE + 64;

// Z[b][i0 + i][n0 + n] = W1i[i0 + i, :] . Bm[b][n0 + n, :], i, n < 128:
// grid (N2 / 128, ceil(N1 / 128), B); rows of W1i past N1 load as zeros
// and their outputs are not stored.
__global__ void __launch_bounds__(BACK_THREADS, 2)
conv_back_kernel(const __grid_constant__ CUtensorMap mw1i,
                 const __grid_constant__ CUtensorMap mbm,
                 bf16* __restrict__ z, int N1, int N2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + BACK_STAGES * BACK_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (BACK_STAGES + s); };
  const int n0 = blockIdx.x * MC, i0 = blockIdx.y * MC, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KT = N1 / KD;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BACK_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == CONSUMERS / 32) {
    if (lane == 0) {
      tma_prefetch_map(&mw1i);
      tma_prefetch_map(&mbm);
      Pos a;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(empty(a.s), a.p ^ 1);
        mbar_expect_tx(full(a.s), BACK_STAGE);
        const uint32_t st = ring + a.s * BACK_STAGE;
        tma_load_2d(st, &mw1i, full(a.s), kt * KD, i0);
        tma_load_2d(st + A_STAGE, &mbm, full(a.s), kt * KD, b * N2 + n0);
        a.next(BACK_STAGES);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  float acc[MC / 2];
#pragma unroll
  for (int i = 0; i < MC / 2; ++i) acc[i] = 0.f;
  Pos a;
  int pend = -1;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(full(a.s), a.p);
    const uint32_t st = ring + a.s * BACK_STAGE;
    const uint32_t ad = desc_lo(st + wg * HALF, 16);
    const uint32_t bd = desc_lo(st + A_STAGE, 16);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss<MC>(acc, make_desc(ad + ((kk * 32) >> 4), HI),
                   make_desc(bd + ((kk * 32) >> 4), HI), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (pend >= 0 && lane == 0) mbar_arrive(empty(pend));
    pend = a.s;
    a.next(BACK_STAGES);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(empty(pend));
  const int wi = warp & 3, g = lane >> 2, tig = lane & 3;
  bf16* zb = z + (long long)b * N1 * N2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + wg * 64 + 16 * wi + g + 8 * h;
    if (i < N1) {
#pragma unroll
      for (int c = 0; c < MC / 8; ++c)
        *reinterpret_cast<unsigned*>(zb + (long long)i * N2 + n0 + 8 * c +
                                     2 * tig) =
            pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
}

template <int BM, int R>
int launch_front(const Maps& mp, bf16* bm, int B, int N1, int N2, int S,
                 cudaStream_t s) {
  return launch_smem(conv_front_kernel<BM, R>, dim3(N1 / BM, B),
                     smem_bytes(BM, S, N2, true), s, mp, bm, N1, N2, S);
}

// One of the two passes at (B, N1, N2) with its plan
template <bool FORWARD, int BM, int R>
int launch_pass(const Maps& mp, bf16* out, int B, int N1, int N2, int S,
                cudaStream_t s) {
  const int smem = smem_bytes(BM, S, N2, false);
  if constexpr (FORWARD)
    return launch_smem(conv_forward_kernel<BM, R>, dim3(N1 / BM, B), smem, s,
                       mp, out, N1, N2, S);
  else
    return launch_smem(conv_inverse_kernel<BM, R>, dim3(N1 / BM, B), smem, s,
                       mp, out, N1, N2, S);
}

template <bool FORWARD>
int launch_pass(const Maps& mp, bf16* out, int B, int N1, int N2, int bm,
                int S, int chunks, cudaStream_t s) {
  const bool slab = chunks > 1;
  switch (bm) {
    case 64:
      return slab ? launch_pass<FORWARD, 64, 4>(mp, out, B, N1, N2, S, s)
                  : launch_pass<FORWARD, 64, 1>(mp, out, B, N1, N2, S, s);
    case 32:
      return slab ? launch_pass<FORWARD, 32, 8>(mp, out, B, N1, N2, S, s)
                  : launch_pass<FORWARD, 32, 1>(mp, out, B, N1, N2, S, s);
    default:
      // the forward pass's N2 (<= MONARCH_CONV_MAX_N2) always fits 32 rows
      if (FORWARD) return static_cast<int>(cudaErrorInvalidValue);
      return slab ? launch_pass<false, 16, 8>(mp, out, B, N1, N2, S, s)
                  : launch_pass<false, 16, 1>(mp, out, B, N1, N2, S, s);
  }
}

}  // namespace

// x (B, N1, N2), w0 (N1, N1), tw (N1, N2), w1 (N2, N2), filt (N2, N1),
// w0i (N2, N2), twi (N2, N1), w1i (N1, N1) -> z (B, N1, N2), all bf16,
// contiguous; bm is scratch of B * N2 * N1 bf16. The plan is
// ops.py::monarch_conv_plan's for this shape: with bm2 == 0, one front
// launch (bm_rows, stages, chunks; conv_front_kernel, phases 1-3, writing
// Bm to the scratch), then conv_back_kernel; else two passes,
// conv_forward_kernel at (B, N1, N2) with the first plan writing F to the
// scratch, then conv_inverse_kernel at (B, N2, N1) with the second (bm2,
// stages2, chunks2). Both on the given stream.
extern "C" int monarch_conv_bf16(const void* x, const void* w0,
                                 const void* tw, const void* w1,
                                 const void* filt, const void* w0i,
                                 const void* twi, const void* w1i, void* bm,
                                 void* z, int B, int N1, int N2, int bm_rows,
                                 int stages, int chunks, int bm2, int stages2,
                                 int chunks2, void* stream) {
  auto Bm = static_cast<bf16*>(bm);
  auto Z = static_cast<bf16*>(z);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bm2 != 0) {
    if (N1 % MC || bm_rows == 16 ||
        !plan_ok(N1, N2, bm_rows, stages, chunks, false) ||
        !plan_ok(N2, N1, bm2, stages2, chunks2, false))
      return static_cast<int>(cudaErrorInvalidValue);
    Maps fwd, inv;
    if (!front_maps(&fwd, x, w0, tw, w1, filt, nullptr, nullptr, B, N1, N2,
                    bm_rows) ||
        !front_maps(&inv, bm, w0i, twi, w1i, nullptr, nullptr, nullptr, B,
                    N2, N1, bm2))
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc =
        launch_pass<true>(fwd, Bm, B, N1, N2, bm_rows, stages, chunks, s);
    if (rc != 0) return rc;
    return launch_pass<false>(inv, Z, B, N2, N1, bm2, stages2, chunks2, s);
  }
  if (!plan_ok(N1, N2, bm_rows, stages, chunks, true))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps mp;
  CUtensorMap mw1i, mbm;
  if (!front_maps(&mp, x, w0, tw, w1, filt, w0i, twi, B, N1, N2, bm_rows) ||
      !map_2d_bf16(&mw1i, w1i, N1, N1, uint64_t(N1) * 2, 64, MC) ||
      !map_2d_bf16(&mbm, bm, N1, uint64_t(B) * N2, uint64_t(N1) * 2, 64, MC))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool slab = chunks > 1;
  int rc;
  if (bm_rows == 32)
    rc = slab ? launch_front<32, 8>(mp, Bm, B, N1, N2, stages, s)
              : launch_front<32, 1>(mp, Bm, B, N1, N2, stages, s);
  else
    rc = slab ? launch_front<16, 8>(mp, Bm, B, N1, N2, stages, s)
              : launch_front<16, 1>(mp, Bm, B, N1, N2, stages, s);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      conv_back_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BACK_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_back_kernel<<<dim3(N2 / MC, (N1 + MC - 1) / MC, B), BACK_THREADS,
                     BACK_SMEM, s>>>(mw1i, mbm, Z, N1, N2);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a launch with this plan, in bytes: the
// front launch (front != 0), a pass, or the back launch (bm_rows 0)
extern "C" int monarch_conv_smem_bytes(int bm_rows, int stages, int N2,
                                       int front) {
  return bm_rows == 0 ? BACK_SMEM
                      : smem_bytes(bm_rows, stages, N2, front != 0);
}

// The opt-in dynamic shared memory a block may have on the current device,
// in bytes: what ops.py::monarch_plan fits a plan into
extern "C" int monarch_smem_limit() { return smem_limit(); }

REPRO_EXPORT_ERROR_STRING
