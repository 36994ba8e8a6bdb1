// Host side of the port's TMA loads: cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point so that a kernel library needs
// no -lcuda, and a cache of 2-D bf16 tensor maps. flash_prefill
// (prefill.cu) encodes its 4-D maps through encode_tiled; the FFN kernels'
// weight stream (stream_gemm.cuh) and the Monarch kernels
// (monarch_core.cuh) take their 2-D maps from map_2d_bf16.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>
#include <mutex>
#include <unordered_map>

namespace repro {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, or nullptr where the driver does not offer it.
// Static here and below: each kernel library keeps its own lookup and
// cache.
static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

struct Map2dKey {
  const void* ptr;
  uint64_t inner, outer, row_bytes;
  uint32_t box_inner, box_outer;
  bool swizzle;
  bool operator==(const Map2dKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer &&
           row_bytes == o.row_bytes && box_inner == o.box_inner &&
           box_outer == o.box_outer && swizzle == o.swizzle;
  }
};

struct Map2dKeyHash {
  size_t operator()(const Map2dKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.ptr);
    for (uint64_t v : {k.inner, k.outer, k.row_bytes,
                       uint64_t(k.box_inner) << 32 | k.box_outer,
                       uint64_t(k.swizzle)})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

// A row-major (outer, inner) bf16 matrix at ptr, rows row_bytes apart, as a
// 2-D map read in boxes of (box_inner, box_outer) elements with the 128-byte
// swizzle (box_inner * 2 == 128), or, with ``swizzle`` false, unswizzled
// (box_inner * 2 a multiple of 16); elements outside the extent load as
// zeros. A map is a pure function of these arguments, so it is cached by
// them: a long-lived weight is encoded once per process, not once per call.
static bool map_2d_bf16(CUtensorMap* map, const void* ptr, uint64_t inner,
                        uint64_t outer, uint64_t row_bytes,
                        uint32_t box_inner, uint32_t box_outer,
                        bool swizzle = true) {
  static std::mutex mu;
  static std::unordered_map<Map2dKey, CUtensorMap, Map2dKeyHash> cache;
  const Map2dKey key{ptr,       inner,     outer,  row_bytes,
                     box_inner, box_outer, swizzle};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();   // bounded: stale pointers age out
  cache.emplace(key, *map);
  return true;
}

}  // namespace repro
