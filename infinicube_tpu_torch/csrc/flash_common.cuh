// Pieces shared by the flash-attention kernels (flash_attention.cu forward,
// flash_attention_bwd.cu backward): K8's tile sizes and global -> shared tile
// copy, bf16 packing, and the TMA map of a [B, N, h, d] view.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // K8: query rows per tile (16 per warp)
constexpr int kBK = 64;       // K8: keys per tile
constexpr int kThreads = 128;  // K8: threads a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Strides {
  long long b, n, h;  // elements between batches, tokens, heads
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy `rows` x `row_bytes` from global (row pitch `pitch_bytes`) into shared
// memory (row pitch `ld_bytes`), zero-filling rows at or past `valid`.
// 16 bytes per thread per step.
__device__ __forceinline__ void load_tile(unsigned char* dst, int ld_bytes,
                                          const unsigned char* src,
                                          long long pitch_bytes, int rows,
                                          int row_bytes, int valid) {
  const int vpr = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * pitch_bytes + c);
    *reinterpret_cast<uint4*>(dst + r * ld_bytes + c) = val;
  }
}

// The tensor map of a [B, N, h, d] view with element strides s, as dims
// (d, h, N, B), in boxes of `cols` columns x `rows` rows of one head under a
// `span`-byte swizzle. bf16 in 32-column (64-byte) slabs unless told
// otherwise; K1's int8 q8 and k8 take whole d-byte rows.
inline bool bnhd_map(CUtensorMap* map, const void* p, int B, int N, int H,
                     int d, Strides s, int rows, int cols = 32, int elem = 2,
                     int span = 64,
                     CUtensorMapDataType type =
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)H, (uint64_t)N,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)(s.h * elem),
                               (uint64_t)(s.n * elem),
                               (uint64_t)(s.b * elem)};
  const uint32_t box[4] = {(uint32_t)cols, 1, (uint32_t)rows, 1};
  return hop_host::make_map(map, p, 4, dims, strides, box, span, type);
}

}  // namespace
