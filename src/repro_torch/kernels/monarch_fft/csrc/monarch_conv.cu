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
// The first three products are local to a block of BM rows of N1, so one
// CTA of 8 warps per (batch row, N1 block) runs them back to back in
// shared memory (monarch_core.cuh): A_blk (BM x N2) as in monarch.cu, then
// F_blk = bf16(bf16(W1 @ A_blk^T) (*) filt[:, blk]) (N2 x BM, k-major),
// then Bm[:, blk] = bf16((W0i @ F_blk) (*) twi[:, blk]), written to device
// memory as Bm (B, N2, N1) bf16, where the oracle rounds it anyway. Only
// the last product, Z[b] = W1i @ Bm[b]^T, contracts across every N1 block;
// the second launch computes it in 64 x 128 tiles, Bm's rows read as the
// product's n-major B operand (the transpose again an access pattern). The
// intermediate costs 2 * B * N1 * N2 * 2 bytes of device traffic (64 MB at
// the 1M-point shape, 0.019 ms at 3.35 TB/s). Every rounding point is the
// oracle's (monarch_conv_ref): each pass's twiddled intermediate and output
// are rounded to bf16, and the filter multiplies the rounded pass output.
// BM is 32, or 16 where 32 does not fit (N2 up to 2304).
//
// A one-launch design (a thread-block cluster sharing the row through
// distributed shared memory) is later work, as are wgmma/TMA and the L2
// re-reads of x[b], W1 and W0i by each of the N1 / BM CTAs of a row.
#include "monarch_core.cuh"

using namespace repro;
using namespace repro::monarch;

namespace {

template <int BM>
__global__ void __launch_bounds__(NTHREADS)
conv_front_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                  const bf16* __restrict__ tw, const bf16* __restrict__ w1,
                  const bf16* __restrict__ filt,
                  const bf16* __restrict__ w0i,
                  const bf16* __restrict__ twi, bf16* __restrict__ bm,
                  int N1, int N2) {
  using P = Pass<BM>;
  constexpr int LDF = BM + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [BM][N2 + PAD]
  bf16* Fs = As + BM * (N2 + PAD);                // [N2][BM + PAD]
  bf16* st = Fs + N2 * LDF;
  const int r0 = blockIdx.x * BM, b = blockIdx.y;
  const long long plane = (long long)N1 * N2;

  P::twiddled_rows(x + b * plane, w0, tw, N1, N2, r0, As, st);
  // F_blk[m0 + i][j] = bf16(bf16(W1[m0 + i, :] . A_blk[j, :]) *
  //                         filt[m0 + i][r0 + j])
  for (int m0 = 0; m0 < N2; m0 += NC) {
    typename P::P2::Acc acc;
    P::P2::run(acc, w1 + (long long)m0 * N2, N2, As, N2 + PAD, N2, st);
    P::P2::each_pair(acc, [&](int r, int c, float v0, float v1) {
      const bf16* f = filt + (long long)(m0 + r) * N1 + r0 + c;
      *reinterpret_cast<unsigned*>(Fs + (m0 + r) * LDF + c) =
          pack_bf16(round_bf16(v0) * to_f(f[0]), round_bf16(v1) * to_f(f[1]));
    });
  }
  __syncthreads();
  // Bm[b][m0 + i][r0 + j] = bf16((W0i[m0 + i, :] . F_blk[:, j]) *
  //                              twi[m0 + i][r0 + j])
  for (int m0 = 0; m0 < N2; m0 += NC) {
    typename P::P3::Acc acc;
    P::P3::run(acc, w0i + (long long)m0 * N2, N2, Fs, LDF, N2, st);
    P::P3::store(acc, st, bm + b * plane + (long long)m0 * N1 + r0, N1,
                 [&](int r, int c, float v0, float v1) {
                   const bf16* t = twi + (long long)(m0 + r) * N1 + r0 + c;
                   return pack_bf16(v0 * to_f(t[0]), v1 * to_f(t[1]));
                 });
  }
}

// Z[b][m0:m0 + 64, n0:n0 + 128] = W1i[m0:m0 + 64, :] @ Bm[b][n0:n0 + 128, :]^T
using Back = Tile<64, 128, 2, 4, B_NK_GLOBAL>;

__global__ void __launch_bounds__(NTHREADS)
conv_back_kernel(const bf16* __restrict__ w1i, const bf16* __restrict__ bm,
                 bf16* __restrict__ z, int N1, int N2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* st = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * 64, b = blockIdx.z;
  const long long plane = (long long)N1 * N2;
  Back::Acc acc;
  Back::run(acc, w1i + (long long)m0 * N1, N1,
            bm + b * plane + (long long)n0 * N1, N1, N1, st);
  Back::store(acc, st, z + b * plane + (long long)m0 * N2 + n0, N2,
              [](int, int, float v0, float v1) { return pack_bf16(v0, v1); });
}

template <int BM>
size_t front_smem_bytes(int N2) {
  return (size_t(BM) * (N2 + PAD) + size_t(N2) * (BM + PAD) +
          Pass<BM>::STAGE_ELEMS) * sizeof(bf16);
}

template <int BM>
int launch_front(const bf16* x, const bf16* w0, const bf16* tw,
                 const bf16* w1, const bf16* filt, const bf16* w0i,
                 const bf16* twi, bf16* bm, int B, int N1, int N2,
                 cudaStream_t s) {
  const size_t bytes = front_smem_bytes<BM>(N2);
  const cudaError_t e = cudaFuncSetAttribute(
      conv_front_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_front_kernel<BM><<<dim3(N1 / BM, B), NTHREADS, bytes, s>>>(
      x, w0, tw, w1, filt, w0i, twi, bm, N1, N2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, N1, N2), w0 (N1, N1), tw (N1, N2), w1 (N2, N2), filt (N2, N1),
// w0i (N2, N2), twi (N2, N1), w1i (N1, N1) -> z (B, N1, N2), all bf16,
// contiguous; bm is scratch of B * N2 * N1 bf16. N1 % 64 == 0 and
// N2 % 128 == 0. Launches conv_front_kernel, then conv_back_kernel, on the
// given stream.
extern "C" int monarch_conv_bf16(const void* x, const void* w0,
                                 const void* tw, const void* w1,
                                 const void* filt, const void* w0i,
                                 const void* twi, const void* w1i, void* bm,
                                 void* z, int B, int N1, int N2,
                                 void* stream) {
  if (B < 1 || N1 < 64 || N1 % 64 || N2 < NC || N2 % NC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto Bm = static_cast<bf16*>(bm);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t limit = static_cast<size_t>(smem_limit());
  int rc;
  if (front_smem_bytes<32>(N2) <= limit)
    rc = launch_front<32>(c(x), c(w0), c(tw), c(w1), c(filt), c(w0i), c(twi),
                          Bm, B, N1, N2, s);
  else if (front_smem_bytes<16>(N2) <= limit)
    rc = launch_front<16>(c(x), c(w0), c(tw), c(w1), c(filt), c(w0i), c(twi),
                          Bm, B, N1, N2, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  constexpr int back_bytes = Back::SMEM_ELEMS * sizeof(bf16);
  const cudaError_t e = cudaFuncSetAttribute(
      conv_back_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      back_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_back_kernel<<<dim3(N2 / 128, N1 / 64, B), NTHREADS, back_bytes, s>>>(
      c(w1i), Bm, static_cast<bf16*>(z), N1, N2);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING
