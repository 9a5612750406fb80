// Pieces shared by the flash-attention kernels (flash_attention.cu forward,
// flash_attention_bwd.cu backward): tile sizes, the bf16 mma.sync wrapper,
// bf16 packing and the global -> shared tile copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per tile (16 per warp)
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Strides {
  long long b, n, h;  // elements between batches, tokens, heads
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
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

}  // namespace
