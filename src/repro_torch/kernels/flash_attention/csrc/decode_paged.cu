// Paged GQA flash-decode for Hopper (sm_90a), each lane's positions split
// across CTAs.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_decode_paged
// (_decode_paged_kernel), reached through flash_attention/ops.py::decode_paged.
//
// Computes, for every lane b and kv head h, the G grouped queries against
// the lane's cached keys and values, gathered position by position through
// the block table tables[b, t / block] of the paged pools
// (rows, block, Hkv, dh), masked to the first len1[b] positions (at most
// maxb * block). A lane whose len1 points at padding rows produces finite
// garbage that the caller ignores, as on the TPU.
//
// Bound: device-memory bytes: (K+V bytes of the lanes' len1 + q + out) /
// 3.35 TB/s. At decode batch sizes nothing is reused, so the design is
// about keeping the memory streaming on every SM.
//
//  * Chunks. CTA (h, b, c) takes positions [c C, min(L, (c + 1) C)) of
//    lane b and kv head h, C = SPLIT_C = 128: at the kernel row's lengths
//    (1..512, 7B width, B = 8) the 512-position lane is streamed by 128
//    CTAs, where one CTA per (lane, head) left it to 32. Of 64 / 128 / 256,
//    128 kept the paged step fastest (its lanes hold 2..121 positions, and
//    a split lane pays a merge) and the kernel row as fast as 64; with
//    every lane at 512 positions 256 was fastest, and one CTA per head
//    faster still (PERF.md). The grid spans maxb * block / C chunks, chunk-major, and a CTA whose chunk
//    starts at or past the lane's L exits at once, so len1 stays on the
//    device.
//  * A page ring. The CTA streams its chunk through a ring of SPLIT_RING
//    stages of SPLIT_STAGE positions (a page at block 16), each stage's K
//    and V rows copied by 16-byte cp.async (zero-filled past L), one commit
//    group a stage, a stage's copies issued as soon as its slot is
//    consumed: 24-32 KB in flight per CTA at dh 128. Each position's row is
//    found through the chunk's block-table entries, staged in shared
//    memory, so a chunk may end inside a page and any block size works.
//    (Letting the next kernel launch once the first copies are issued -
//    programmatic dependent launch, so that the out-projection's weight
//    loads run under attention - made the paged step slower: PERF.md.)
//  * Arithmetic in f32, as decode_core.cuh's: dh / 8 lanes a position
//    (16-byte shared loads, shuffles), each lane group with its own online
//    softmax state (m, l, acc) over its positions of every stage; at the
//    chunk's end the groups merge by shuffles within each warp, then warp
//    by warp in a fixed order: the chunk's partial state.
//  * A deterministic merge. A lane with one chunk writes o = acc / l.
//    Otherwise every CTA stores its partial (acc, m, l) in its slot of the
//    workspace, and the last CTA of (b, h) to arrive - a per-(b, h)
//    counter, added to with release / acquire semantics at device scope
//    and reset by that CTA - merges the lane's partials in chunk order:
//    M = max m_c, o = sum_c acc_c e^(m_c - M) / sum_c l_c e^(m_c - M). No
//    atomics touch values: two launches agree bit for bit.
//
// decode_paged_split_ref in flash_attention/ref.py is this arithmetic
// written plainly (its partials per chunk; the order of the sums within a
// chunk differs).
#include "decode_core.cuh"
#include "mma_sync.cuh"

using namespace repro;

namespace {

using bf16 = __nv_bfloat16;

constexpr int SPLIT_C = 128;                // positions per CTA
constexpr int SPLIT_STAGE = 16;             // positions per ring stage
constexpr int SPLIT_RING = 4;               // stages in the ring
constexpr int SPLIT_THREADS = 128;
constexpr int SPLIT_NW = SPLIT_THREADS / 32;
constexpr int SPLIT_TABLE = SPLIT_C + 1;    // most pages a chunk touches
constexpr int MERGE_LOADS = 8;              // partials in flight in a merge
static_assert(SPLIT_C % SPLIT_STAGE == 0 && SPLIT_RING >= 2, "ring");

// Shared memory of the CTA: the ring's K and V rows (bf16), then the
// chunk's block-table entries. At the chunk's end the warps' states
// reuse the ring: acc (NW, GT, DH) and m, l (NW, GT) in f32.
template <int DH, int GT>
struct Split {
  static constexpr int D8 = DH / 8;               // 16-byte vectors a row
  static constexpr int STAGE = SPLIT_STAGE * DH;  // elements of K (of V)
  static constexpr int RING = 2 * SPLIT_RING * STAGE;
  static constexpr int BYTES = RING * 2 + SPLIT_TABLE * 4;
  static_assert(SPLIT_NW * GT * (DH + 2) * 4 <= RING * 2, "states in ring");
  // floats of one partial in the workspace: acc (GT, DH), m (GT), l (GT),
  // padded to 16 bytes
  static constexpr int SLOT = (GT * (DH + 2) + 3) / 4 * 4;
};

__device__ __forceinline__ void lds_vec8(const bf16* p, float (&out)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void store_bf16x4(bf16* p, float4 v) {
  uint2 r;
  r.x = pack_bf16(v.x, v.y);
  r.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ void fma4(float4& a, const float4& b, float e) {
  a.x += b.x * e;
  a.y += b.y * e;
  a.z += b.z * e;
  a.w += b.w * e;
}

// q, out: (B, Hkv, GT, DH); part: (B * Hkv, gridDim.z, SLOT) floats;
// counters: (B * Hkv) ints, zero between launches.
template <int DH, int GT>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ len1, bf16* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    int Hkv, int block, int maxb, float scale) {
  using S = Split<DH, GT>;
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * SPLIT_C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // (RING, K | V, STAGE)
  int* pages = reinterpret_cast<int*>(ring + S::RING);
  __shared__ int last;

  // the chunk's first table entries, loaded beside len1 (they do not
  // depend on it)
  const int* tb = tables + (size_t)b * maxb;
  const int p0 = t0 / block;
  const int first = p0 + tid < maxb ? __ldg(tb + p0 + tid) : 0;
  const int L = min(__ldg(len1 + b), maxb * block);
  const int nc = max(1, (L + SPLIT_C - 1) / SPLIT_C);    // the lane's chunks
  if (c >= nc) return;
  const int nv = max(0, min(SPLIT_C, L - t0));            // its positions
  const int ns = (nv + SPLIT_STAGE - 1) / SPLIT_STAGE;    // its stages
  const int np = nv > 0 ? (t0 + nv - 1) / block - p0 + 1 : 0;
  if (tid < np) pages[tid] = first;
  for (int i = tid + SPLIT_THREADS; i < np; i += SPLIT_THREADS)
    pages[i] = __ldg(tb + p0 + i);
  __syncthreads();

  // stage x of the chunk into its ring slot: positions x * STAGE + r
  const size_t tok = (size_t)Hkv * DH, hoff = (size_t)h * DH;
  constexpr int SV = SPLIT_STAGE * S::D8;                 // vectors a stage
  auto issue = [&](int x) {
    if (x < ns) {
      bf16* ks = ring + (x % SPLIT_RING) * 2 * S::STAGE;
      bf16* vs = ks + S::STAGE;
#pragma unroll
      for (int j = 0; j < (SV + SPLIT_THREADS - 1) / SPLIT_THREADS; ++j) {
        const int i = tid + j * SPLIT_THREADS;
        if (SV % SPLIT_THREADS == 0 || i < SV) {
          const int r = i / S::D8, v = i % S::D8;
          const int t = t0 + x * SPLIT_STAGE + r;
          const bool ok = t < t0 + nv;
          const size_t row =
              ok ? (size_t)pages[t / block - p0] * block + t % block : 0;
          const size_t off = row * tok + hoff + v * 8;
          cp_async16(ks + r * DH + v * 8, kp + off, ok);
          cp_async16(vs + r * DH + v * 8, vp + off, ok);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int x = 0; x < SPLIT_RING - 1; ++x) issue(x);

  constexpr int LPT = S::D8;                // lanes a position
  constexpr int TPW = 32 / LPT;             // positions a warp step
  const int grp = lane / LPT, gl = lane % LPT;
  float qf[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    load_vec<bf16, 8>(q + ((size_t)(b * Hkv + h) * GT + g) * DH + gl * 8,
                      qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
  }
  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  // ---- the ring: wait for stage x, refill the slot stage x - 1 used,
  // then every lane group takes its positions of stage x
  for (int x = 0; x < ns; ++x) {
    cp_async_wait<SPLIT_RING - 2>();
    __syncthreads();
    issue(x + SPLIT_RING - 1);
    const bf16* ks = ring + (x % SPLIT_RING) * 2 * S::STAGE;
    const bf16* vs = ks + S::STAGE;
    // whole warps step together: the sums shuffle across the warp
    for (int base = warp * TPW; base < SPLIT_STAGE;
         base += SPLIT_NW * TPW) {
      const int r = base + grp;
      const bool valid = x * SPLIT_STAGE + r < nv;
      float kf[8], vf[8];
      lds_vec8(ks + r * DH + gl * 8, kf);
      lds_vec8(vs + r * DH + gl * 8, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += qf[g][i] * kf[i];
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (valid) {
          const float mn = fmaxf(m[g], s);
          const float alpha = expf(m[g] - mn);
          const float p = expf(s - mn);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = acc[g][i] * alpha + p * vf[i];
          m[g] = mn;
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- the lane groups of each warp, then the warps, in a fixed order
#pragma unroll
  for (int o = LPT; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float pm = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float pl = __shfl_xor_sync(0xffffffffu, l[g], o);
      float cs, co;
      merge_state(m[g], l[g], pm, pl, cs, co);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pa = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * cs + pa * co;
      }
    }
  }
  __syncthreads();                                 // the ring is free
  float* wacc = reinterpret_cast<float*>(ring);    // (NW, GT, DH)
  float* wm = wacc + SPLIT_NW * GT * DH;           // (NW, GT)
  float* wl = wm + SPLIT_NW * GT;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float4* d = reinterpret_cast<float4*>(wacc + (warp * GT + g) * DH +
                                            gl * 8);
      d[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      d[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      if (gl == 0) {
        wm[warp * GT + g] = m[g];
        wl[warp * GT + g] = l[g];
      }
    }
  }
  __syncthreads();
  constexpr int N4 = GT * DH / 4;                  // float4s of acc
  // the chunk's acc of float4 e4, and its query's m and l
  auto chunk_state = [&](int e4, float& M, float& lc) {
    const int g = e4 * 4 / DH;
    M = -INFINITY;
#pragma unroll
    for (int w = 0; w < SPLIT_NW; ++w) M = fmaxf(M, wm[w * GT + g]);
    lc = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < SPLIT_NW; ++w) {
      const float mw = wm[w * GT + g];
      const float e = mw == -INFINITY ? 0.f : expf(mw - M);
      lc += wl[w * GT + g] * e;
      fma4(a, reinterpret_cast<const float4*>(wacc + w * GT * DH)[e4], e);
    }
    return a;
  };

  const int bh = b * Hkv + h;
  bf16* o = out + (size_t)bh * GT * DH;
  if (nc == 1) {
    for (int e4 = tid; e4 < N4; e4 += SPLIT_THREADS) {
      float M, lc;
      const float4 a = chunk_state(e4, M, lc);
      lc = fmaxf(lc, 1e-30f);
      store_bf16x4(o + e4 * 4,
                   make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc));
    }
    return;
  }

  // ---- this chunk's partial to its slot; the lane's last CTA merges
  float* base = part + (size_t)bh * gridDim.z * S::SLOT;
  float* slot = base + (size_t)c * S::SLOT;
  for (int e4 = tid; e4 < N4; e4 += SPLIT_THREADS) {
    float M, lc;
    const float4 a = chunk_state(e4, M, lc);
    __stcg(reinterpret_cast<float4*>(slot) + e4, a);
    if (e4 * 4 % DH == 0) {
      __stcg(slot + GT * DH + e4 * 4 / DH, M);
      __stcg(slot + GT * DH + GT + e4 * 4 / DH, lc);
    }
  }
  __syncthreads();                  // the CTA's stores before the release
  if (tid == 0) {
    last = atom_add_acq_rel(counters + bh, 1) == nc - 1;
    if (last) counters[bh] = 0;                 // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  for (int e4 = tid; e4 < N4; e4 += SPLIT_THREADS) {
    const int g = e4 * 4 / DH;
    float M = -INFINITY;
    for (int k = 0; k < nc; ++k)
      M = fmaxf(M, __ldcg(base + (size_t)k * S::SLOT + GT * DH + g));
    float lt = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    // the partials in chunk order, MERGE_LOADS chunks' loads in flight
    for (int k0 = 0; k0 < nc; k0 += MERGE_LOADS) {
      float4 ak[MERGE_LOADS];
      float mk[MERGE_LOADS], lk[MERGE_LOADS];
#pragma unroll
      for (int j = 0; j < MERGE_LOADS; ++j)
        if (k0 + j < nc) {
          const float* sk = base + (size_t)(k0 + j) * S::SLOT;
          ak[j] = __ldcg(reinterpret_cast<const float4*>(sk) + e4);
          mk[j] = __ldcg(sk + GT * DH + g);
          lk[j] = __ldcg(sk + GT * DH + GT + g);
        }
#pragma unroll
      for (int j = 0; j < MERGE_LOADS; ++j)
        if (k0 + j < nc) {
          const float e = mk[j] == -INFINITY ? 0.f : expf(mk[j] - M);
          lt += lk[j] * e;
          fma4(a, ak[j], e);
        }
    }
    lt = fmaxf(lt, 1e-30f);
    store_bf16x4(o + e4 * 4,
                 make_float4(a.x / lt, a.y / lt, a.z / lt, a.w / lt));
  }
}

// Launches one instantiation. The dynamic shared memory opt-in (above 48
// KB) is set once per device; static, so each kernel library keeps its
// own record of it.
template <int DH, int GT>
static int launch_split(const bf16* q, const bf16* kp, const bf16* vp,
                        const int* tables, const int* len1, bf16* out,
                        float* part, int* counters, int B, int Hkv, int block,
                        int maxb, float scale, cudaStream_t stream) {
  constexpr int SMEM = Split<DH, GT>::BYTES;
  static unsigned opted = 0;                 // one bit per device
  if (SMEM > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(__atomic_load_n(&opted, __ATOMIC_ACQUIRE) >> dev & 1u)) {
      e = cudaFuncSetAttribute(decode_split_kernel<DH, GT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
      if (e != cudaSuccess) return static_cast<int>(e);
      __atomic_fetch_or(&opted, 1u << dev, __ATOMIC_RELEASE);
    }
  }
  const int chunks = (maxb * block + SPLIT_C - 1) / SPLIT_C;
  decode_split_kernel<DH, GT><<<dim3(Hkv, B, chunks), SPLIT_THREADS, SMEM,
                                stream>>>(q, kp, vp, tables, len1, out, part,
                                          counters, Hkv, block, maxb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// positions per CTA: the wrapper sizes the workspace by it
extern "C" int decode_paged_chunk() { return SPLIT_C; }

// dynamic shared memory of the instantiation for (dh, G), 0 if none
extern "C" int decode_paged_smem_bytes(int dh, int G) {
  const int bytes = with_head_shape(dh, G, [](auto dh_c, auto g_c) {
    return Split<decltype(dh_c)::value, decltype(g_c)::value>::BYTES;
  });
  return bytes == static_cast<int>(cudaErrorInvalidValue) ? 0 : bytes;
}

// part: (B * Hkv, chunks, slot) floats with chunks = ceil(maxb * block /
// chunk) and slot = G * (dh + 2) rounded up to a multiple of 4; counters:
// B * Hkv ints, zero (the kernel leaves them so).
extern "C" int decode_paged_bf16(const void* q, const void* kp, const void* vp,
                                 const void* tables, const void* len1,
                                 void* out, void* part, void* counters, int B,
                                 int Hkv, int G, int dh, int block, int maxb,
                                 float scale, void* stream) {
  return with_head_shape(dh, G, [&](auto dh_c, auto g_c) {
    constexpr int DH = decltype(dh_c)::value, GT = decltype(g_c)::value;
    return launch_split<DH, GT>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), static_cast<const int*>(tables),
        static_cast<const int*>(len1), static_cast<bf16*>(out),
        static_cast<float*>(part), static_cast<int*>(counters), B, Hkv,
        block, maxb, scale, static_cast<cudaStream_t>(stream));
  });
}

REPRO_EXPORT_ERROR_STRING
