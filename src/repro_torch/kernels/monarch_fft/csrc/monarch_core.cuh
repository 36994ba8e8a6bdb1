// Product loops shared by the Monarch kernels (monarch.cu, monarch_conv.cu).
//
// Every product here is one CTA of 8 warps computing a CM x CN tile of
// C = A (CM x K) * B (K x CN) on mma.sync.m16n8k16 (bf16 in, f32
// accumulate). A is a row-major matrix in device memory (a factor: W0, W1,
// W0i, W1i), streamed through two shared-memory stages of BK columns by
// cp.async. B is either streamed the same way or already resident in shared
// memory (the Monarch intermediates), stored k-major ([k][n], fragments by
// ldmatrix.trans) or n-major ([n][k], plain ldmatrix). Storing the
// intermediate n-major is what folds the transpose of the Pallas kernel
// into the second product's access pattern: A_blk^T is never formed.
#pragma once

#include "mma_sync.cuh"

namespace repro {
namespace monarch {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;  // 8 warps
constexpr int PAD = 8;         // bf16 padding per shared-memory row: the 8
                               // rows of an 8x8 ldmatrix fall in distinct banks
constexpr int BK = 64;         // depth of one streamed k step
constexpr int NC = 128;        // width of a Monarch row chunk (N2 % NC == 0)

// Where a product's B operand (K x CN) lives and how it is stored.
enum BMode {
  B_KN_GLOBAL,  // device memory, row k holds the tile's CN values (x[b])
  B_NK_GLOBAL,  // device memory, row n holds K values (Bm[b]: W1i @ Bm^T)
  B_NK_SMEM,    // resident shared memory [n][k] (A_blk: W1 @ A_blk^T)
  B_KN_SMEM,    // resident shared memory [k][n] (F_blk: W0i @ F_blk)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int CM, int CN, int WM, int WN, int MODE>
struct Tile {
  static_assert(WM * WN == NTHREADS / 32, "eight warps");
  static constexpr int MT = CM / 16 / WM;  // 16-row m tiles per warp
  static constexpr int NT = CN / 8 / WN;   // 8-column n tiles per warp
  static_assert(MT >= 1 && CM == MT * 16 * WM, "warp rows");
  static_assert(NT >= 2 && NT % 2 == 0 && CN == NT * 8 * WN, "warp columns");
  static constexpr bool B_STREAMED = MODE == B_KN_GLOBAL || MODE == B_NK_GLOBAL;
  static constexpr bool B_KN = MODE == B_KN_GLOBAL || MODE == B_KN_SMEM;
  static constexpr int LDA = BK + PAD;                     // A stage row
  static constexpr int LDB = B_KN ? CN + PAD : BK + PAD;   // B stage row
  static constexpr int A_ELEMS = CM * LDA;
  static constexpr int B_ELEMS = B_STREAMED ? (B_KN ? BK : CN) * LDB : 0;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM_ELEMS = 2 * STAGE;             // two stages
  static constexpr int LDO = CN + PAD;                     // output staging
  static_assert(CM * LDO <= SMEM_ELEMS, "output staging fits the stages");

  using Acc = float[MT][NT][4];

  // k step [k0, k0 + BK) of A (and of a streamed B) into stage st
  __device__ static void load(bf16* st, const bf16* A, long long lda,
                              const bf16* B, long long ldb, int k0) {
    constexpr int CA = BK / 8;              // 16-byte chunks per A row
    for (int i = threadIdx.x; i < CM * CA; i += NTHREADS) {
      const int r = i / CA, c = i % CA;
      cp_async16(st + r * LDA + c * 8, A + r * lda + k0 + c * 8, true);
    }
    bf16* Bs = st + A_ELEMS;
    if constexpr (MODE == B_KN_GLOBAL) {
      constexpr int CB = CN / 8;
      for (int i = threadIdx.x; i < BK * CB; i += NTHREADS) {
        const int r = i / CB, c = i % CB;
        cp_async16(Bs + r * LDB + c * 8, B + (k0 + r) * ldb + c * 8, true);
      }
    } else if constexpr (MODE == B_NK_GLOBAL) {
      for (int i = threadIdx.x; i < CN * CA; i += NTHREADS) {
        const int r = i / CA, c = i % CA;
        cp_async16(Bs + r * LDB + c * 8, B + r * ldb + k0 + c * 8, true);
      }
    }
  }

  // acc = A (CM x K) * B (K x CN), K a multiple of BK. A: device memory,
  // row stride lda. B: device memory with row stride ldb (streamed), or
  // resident shared memory with row stride ldb. st: SMEM_ELEMS elements of
  // shared memory. All threads call it; it ends with a barrier, so st is
  // free again when it returns.
  __device__ static void run(Acc& acc, const bf16* A, long long lda,
                             const bf16* B, long long ldb, int K, bf16* st) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = (warp / WN) * MT * 16, col0 = (warp % WN) * NT * 8;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    const int KT = K / BK;
    load(st, A, lda, B, ldb, 0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      const bf16* cur = st + (kt & 1) * STAGE;
      if (kt + 1 < KT) {
        load(st + ((kt + 1) & 1) * STAGE, A, lda, B, ldb, (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // B's tile, its row stride, and the k offset of this step within it
      const bf16* Bs = B_STREAMED ? cur + A_ELEMS : B;
      const long long ldbs = B_STREAMED ? LDB : ldb;
      const int kb = B_STREAMED ? 0 : kt * BK;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_x4(a[m], cur + (row0 + m * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * LDA +
                            kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int n = col0 + np * 16;
          unsigned b[4];
          if constexpr (B_KN)
            ldsm_x4_trans(b, Bs + (kb + kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * ldbs +
                                 n + (lane >> 4) * 8);
          else
            ldsm_x4(b, Bs + (n + (lane & 7) + (lane >> 4) * 8) * ldbs + kb +
                           kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][2 * np], a[m], b[0], b[1]);
            mma_bf16(acc[m][2 * np + 1], a[m], b[2], b[3]);
          }
        }
      }
      __syncthreads();            // the stage is refilled next step
    }
  }

  // f(row, col, v0, v1) for each pair of accumulators: tile row, even tile
  // column col and col + 1
  template <class F>
  __device__ static void each_pair(const Acc& acc, F&& f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = (warp / WN) * MT * 16 + (lane >> 2);
    const int col0 = (warp % WN) * NT * 8 + (lane & 3) * 2;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(row0 + m * 16 + h * 8, col0 + n * 8, acc[m][n][2 * h],
            acc[m][n][2 * h + 1]);
  }

  // out[r * ldo + c] = pair(r, c, v0, v1) (two packed bf16) for the tile,
  // staged through st so that each output row leaves in 16-byte stores.
  // Call right after run(); ends with a barrier.
  template <class F>
  __device__ static void store(const Acc& acc, bf16* st, bf16* out,
                               long long ldo, F&& pair) {
    each_pair(acc, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<unsigned*>(st + r * LDO + c) = pair(r, c, v0, v1);
    });
    __syncthreads();
    constexpr int CO = CN / 8;
    for (int i = threadIdx.x; i < CM * CO; i += NTHREADS) {
      const int r = i / CO, c = i % CO;
      *reinterpret_cast<uint4*>(out + r * ldo + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * LDO + c * 8);
    }
    __syncthreads();
  }
};

// The two products of one Monarch pass at N1-row block size BM: phase 1,
// A_blk = W0[blk] @ x[b] (BM x N2), by NC-column chunks, x streamed; phase
// 2 and the conv's phase 3, (NC rows of a factor) @ (a resident BM-column
// intermediate), by NC-row chunks.
template <int BM>
struct Pass {
  static constexpr int WM1 = BM >= 32 ? 2 : 1;
  static constexpr int WN2 = BM >= 32 ? 2 : 1;
  using P1 = Tile<BM, NC, WM1, 8 / WM1, B_KN_GLOBAL>;       // W0[blk] @ x[b]
  using P2 = Tile<NC, BM, 8 / WN2, WN2, B_NK_SMEM>;         // W1 @ A_blk^T
  using P3 = Tile<NC, BM, 8 / WN2, WN2, B_KN_SMEM>;         // W0i @ F_blk
  static constexpr int STAGE_ELEMS =
      P1::SMEM_ELEMS > P2::SMEM_ELEMS ? P1::SMEM_ELEMS : P2::SMEM_ELEMS;
  static_assert(P3::SMEM_ELEMS <= STAGE_ELEMS, "phase 3 stages fit");

  // As[i][n] = bf16((W0[r0 + i, :] @ xb)[n] * tw[r0 + i][n]), i < BM, n <
  // N2: the twiddled rows of one N1 block, rounded to bf16 where the oracle
  // casts them (monarch_ref: a.astype(w1.dtype)). Ends with a barrier.
  __device__ static void twiddled_rows(const bf16* xb, const bf16* w0,
                                       const bf16* tw, int N1, int N2, int r0,
                                       bf16* As, bf16* st) {
    const int lds = N2 + PAD;
    for (int n0 = 0; n0 < N2; n0 += NC) {
      typename P1::Acc acc;
      P1::run(acc, w0 + (long long)r0 * N1, N1, xb + n0, N2, N1, st);
      P1::each_pair(acc, [&](int r, int c, float v0, float v1) {
        const bf16* t = tw + (long long)(r0 + r) * N2 + n0 + c;
        *reinterpret_cast<unsigned*>(As + r * lds + n0 + c) =
            pack_bf16(v0 * to_f(t[0]), v1 * to_f(t[1]));
      });
    }
    __syncthreads();
  }
};

// Dynamic shared memory of the monarch kernel (As + stages), in bytes
template <int BM>
inline size_t monarch_smem_bytes(int N2) {
  return (size_t(BM) * (N2 + PAD) + Pass<BM>::STAGE_ELEMS) * sizeof(bf16);
}

// The largest opt-in dynamic shared memory a block may have on this device
inline int smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

}  // namespace monarch
}  // namespace repro
