// The fused Monarch pass (paper Fig. 3) for Hopper (sm_90a):
//
//     Z[b] = W1 . ((W0 . x[b]) (*) tw)^T        x (B, N1, N2) -> Z (B, N2, N1)
//
// Replaces: src/repro/kernels/monarch_fft/kernel.py::monarch_fused
// (_monarch_kernel), reached through monarch_fft/ops.py::monarch.
//
// Bound: tensor-core operations. 4 * B * N1 * N2 * (N1 + N2) / 2 flops (two
// products) against x, the three factors and Z read or written once: at
// the paper's 1M-point shape (16, 1024, 1024) 6.87e10 flops and 73.4 MB,
// 0.0695 ms at 989 TFLOP/s (0.022 ms of bytes).
//
// Design: the Pallas kernel's grid (B, N1 / blk), one CTA of 8 warps per
// (batch row, block of BM rows of N1). Phase 1 computes A_blk = (W0[blk] @
// x[b]) (*) tw[blk] by 128-column chunks on mma.sync (W0 rows and x tiles
// streamed by cp.async through two shared-memory stages), multiplies the
// twiddle in registers, rounds to bf16 where the oracle casts, and keeps
// the whole BM x N2 A_blk in shared memory (128 KB at BM 64, N2 1024).
// Phase 2 streams W1 by 128-row chunks and contracts it with A_blk read
// n-major from shared memory, which is A_blk^T as the product's B operand:
// the transpose is an access pattern, as in the Pallas kernel, and the
// intermediate never reaches device memory. Each Z tile (128 x BM) leaves
// through shared memory in 16-byte row stores. BM is the largest of 64,
// 32, 16 whose shared memory fits the block (N2 up to 5888).
//
// Not yet fast: x[b] and W1 are re-read from L2 by each of the N1 / BM
// CTAs of a batch row (16x at the 1M-point shape), and mma.sync runs below
// the wgmma rate; a wgmma/TMA pipeline and a cluster sharing x[b] are
// later work.
#include "monarch_core.cuh"

using namespace repro;
using namespace repro::monarch;

namespace {

template <int BM>
__global__ void __launch_bounds__(NTHREADS)
monarch_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
               const bf16* __restrict__ tw, const bf16* __restrict__ w1,
               bf16* __restrict__ z, int N1, int N2) {
  using P = Pass<BM>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [BM][N2 + PAD]
  bf16* st = As + BM * (N2 + PAD);
  const int r0 = blockIdx.x * BM, b = blockIdx.y;
  const long long plane = (long long)N1 * N2;

  P::twiddled_rows(x + b * plane, w0, tw, N1, N2, r0, As, st);
  // Z[b][m0 + i][r0 + j] = (W1[m0 + i, :] . A_blk[j, :])
  for (int m0 = 0; m0 < N2; m0 += NC) {
    typename P::P2::Acc acc;
    P::P2::run(acc, w1 + (long long)m0 * N2, N2, As, N2 + PAD, N2, st);
    P::P2::store(acc, st, z + b * plane + (long long)m0 * N1 + r0, N1,
                 [](int, int, float v0, float v1) {
                   return pack_bf16(v0, v1);
                 });
  }
}

template <int BM>
int launch(const bf16* x, const bf16* w0, const bf16* tw, const bf16* w1,
           bf16* z, int B, int N1, int N2, size_t bytes, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      monarch_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  monarch_kernel<BM><<<dim3(N1 / BM, B), NTHREADS, bytes, s>>>(x, w0, tw, w1,
                                                               z, N1, N2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, N1, N2), w0 (N1, N1), tw (N1, N2), w1 (N2, N2) -> z (B, N2, N1),
// all bf16, contiguous. N1 % 64 == 0 and N2 % 128 == 0.
extern "C" int monarch_bf16(const void* x, const void* w0, const void* tw,
                            const void* w1, void* z, int B, int N1, int N2,
                            void* stream) {
  if (B < 1 || N1 < 64 || N1 % 64 || N2 < NC || N2 % NC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto X = static_cast<const bf16*>(x);
  auto W0 = static_cast<const bf16*>(w0);
  auto TW = static_cast<const bf16*>(tw);
  auto W1 = static_cast<const bf16*>(w1);
  auto Z = static_cast<bf16*>(z);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t limit = static_cast<size_t>(smem_limit());
  if (monarch_smem_bytes<64>(N2) <= limit)
    return launch<64>(X, W0, TW, W1, Z, B, N1, N2, monarch_smem_bytes<64>(N2), s);
  if (monarch_smem_bytes<32>(N2) <= limit)
    return launch<32>(X, W0, TW, W1, Z, B, N1, N2, monarch_smem_bytes<32>(N2), s);
  if (monarch_smem_bytes<16>(N2) <= limit)
    return launch<16>(X, W0, TW, W1, Z, B, N1, N2, monarch_smem_bytes<16>(N2), s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT_ERROR_STRING
