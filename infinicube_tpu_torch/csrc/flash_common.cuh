// Pieces shared by the flash-attention kernels (flash_attention.cu forward,
// flash_attention_bwd.cu backward): constants, bf16 packing, and the TMA map
// of a [B, N, h, d] view.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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
