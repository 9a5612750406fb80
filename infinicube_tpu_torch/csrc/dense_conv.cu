// Dense 3x3x3 stride-1 SAME convolution for Hopper (sm_90a), NDHWC bf16,
// behind a plain C interface (loaded with ctypes by
// infinicube_tpu_torch/kernels).
//
// conv3x3x3_bf16 (K3) replaces the TPU kernel
//   infinicube_tpu/ops/dense_conv.py:177 `_pallas_conv` (reached through
//   `conv3x3x3` and the `Conv3x3x3` module), which runs every 3x3x3 conv of
//   the voxel-diffusion UNet: 48 per UNet call at C in {16 .. 1536},
//   O in {192, 384, 768}, on 64^3 .. 8^3 cubes. As on the TPU
//   (`_conv_bwd`, dense_conv.py:302), the same kernel also computes the
//   conv's input gradient: the output gradient [B, D, H, W, O] goes through
//   it with the weights flipped along dz, dy, dx and in/out swapped, packed
//   as [C, 27*O], and a null bias (47 more launches per training step).
//   out[b, z, y, x, o] = bias[o] + sum_{dz, dy, dx, c}
//       x[b, z+dz-1, y+dy-1, x+dx-1, c] * w[o, dz, dy, dx, c]
//   with zeros outside the volume, f32 accumulation and bf16 output.
//
// What bounds it: 2 * 27 * C * O operations per output voxel against
// (C + O) * 2 bytes moved, thousands of operations per byte at C, O >= 192,
// so it is tensor-core bound (989 TFLOP/s bf16 on an H100 SXM).
//
// Design (a first, simple version): an implicit GEMM with M = B*D*H*W output
// voxels, N = O and K = 27*C in (tap, channel) order. The TPU kernel's merged
// (y, w) rows, its three dy views and its roll-and-mask x taps existed for the
// TPU's tile layout and are not carried over. Each block of 4 warps owns a
// 128-voxel x 64-channel output tile and walks the 27 taps and, inside each,
// 32-channel chunks of C. For every chunk it stages the tap-shifted input
// rows (zero-filled at the volume's borders, the SAME halo, and past C) and
// the matching weight rows in shared memory with cp.async, three stages deep,
// reads them with ldmatrix and multiplies with mma.sync m16n8k16 bf16 into
// f32 registers. The epilogue adds the f32 bias (none when the pointer is
// null) and stores bf16. No TMA or
// wgmma yet. The weights arrive packed once per module as [O, 27*C] bf16
// (k = tap*C + c, tap = dz*9 + dy*3 + dx) by the caller.
//
// conv3x3x3_int8 (K7) replaces the int8 branch of the same TPU kernel
//   (`_pallas_conv` with `swx`, dense_conv.py:136-174, fed by
//   `_quantize_for_conv` :251), which serves the UNet's convs under
//   `DiffusionConfig.serve_quant` where the reference's plan fits (23 of the
//   48 at release). x arrives as int8 with one scale per input channel
//   folded into the int8 weights, which carry one f32 scale per (dx, output
//   channel), sw [3, O]:
//   out[v, o] = bias[o] + sum_dx sw[dx, o] * f32(sum_{dz, dy, c} x8 * w8)
//   with each dx group's sum exact in int32 and the three added as the
//   reference does (t1 + t0, then + t2), then the bias, then bf16.
//
// What bounds it: the same 2 * 27 * C * O operations per voxel as K3 on the
// int8 tensor cores (1,979 TOP/s on an H100 SXM), against (C + 2 * O) bytes.
//
// Design (a first, simple version): K3's implicit GEMM with int8 operands.
// The weights arrive packed [O, 27*C] int8 with k = (dx*9 + dz*3 + dy)*C + c,
// so K runs one dx group after the other; a stage holds 64 channels (64
// bytes a row, K3's shared-memory geometry), ldmatrix reads the byte tiles
// as b16 tiles (which is the s8 fragment layout) and mma.sync m16n8k32 s8
// accumulates into int32 registers. At the end of each dx group the int32
// sums are converted, scaled by sw[dx, o] and added into f32 registers
// (rounded multiply and add, no fused multiply-add, so the result equals the
// plain version's), and the int32 registers restart at 0.
//
// The entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output voxels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // input channels per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kLd = kBK + 8;  // bf16 row pitch in shared memory (80 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; copies zeros instead when !pred (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
    conv3x3x3_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int D, int H, int W,
                     int C, int O, int M) {
  __shared__ __align__(128) __nv_bfloat16 sA[kStages][kBM * kLd];
  __shared__ __align__(128) __nv_bfloat16 sB[kStages][kBN * kLd];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // One grid.x of (M tile, O tile) pairs, O tile fastest, so the blocks that
  // run together share their input rows in L2 (grid.y would stop at 65,535
  // M tiles).
  const int n_tiles = (O + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int cv = (tid % 4) * 8;  // this thread's 8-channel column of a chunk

  // The 4 rows of the A tile this thread stages, and their coordinates.
  int rb[4], rz[4], ry[4], rx[4];
  bool rok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / 4 + 32 * j;
    rok[j] = m < M;
    const int mm = rok[j] ? m : 0;
    rx[j] = mm % W;
    ry[j] = (mm / W) % H;
    rz[j] = (mm / (W * H)) % D;
    rb[j] = mm / (W * H * D);
  }

  const int kc = (C + kBK - 1) / kBK;  // channel chunks per tap
  const int iters = 27 * kc;
  const long long wrow = 27LL * C;

  auto load_stage = [&](int stage, int it) {
    const int tap = it / kc;
    const int c = (it % kc) * kBK + cv;
    const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
    const bool cok = c < C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int z = rz[j] + dz, y = ry[j] + dy, xx = rx[j] + dx;
      const bool ok = cok && rok[j] && z >= 0 && z < D && y >= 0 && y < H &&
                      xx >= 0 && xx < W;
      const __nv_bfloat16* src =
          ok ? x + ((((long long)rb[j] * D + z) * H + y) * W + xx) * C + c
             : x;
      cp_async16(&sA[stage][(tid / 4 + 32 * j) * kLd + cv], src, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = tid / 4 + 32 * j;
      const bool ok = cok && n0 + n < O;
      const __nv_bfloat16* src =
          ok ? w + (long long)(n0 + n) * wrow + (long long)tap * C + c : w;
      cp_async16(&sB[stage][n * kLd + cv], src, ok);
    }
  };

  // warp tile: 64 rows x 32 channels = 4 x 4 mma tiles
  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed; stage `it - 1` is consumed
    const int nxt = it + kStages - 1;
    if (nxt < iters) load_stage(nxt % kStages, nxt);
    cp_async_commit();

    const __nv_bfloat16* a_s = sA[it % kStages];
    const __nv_bfloat16* b_s = sB[it % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_s + (wm + mi * 16 + lane % 16) * kLd + kk +
                                (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn + nj * 8 + lane % 8 + (lane / 16) * 8) * kLd +
                           kk + ((lane / 8) % 2) * 8);
        bf[nj][0] = r[0];
        bf[nj][1] = r[1];
        bf[nj + 1][0] = r[2];
        bf[nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int n = n0 + wn + nj * 8 + 2 * t;
    if (n >= O) continue;
    const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * O + n) =
            __floats2bfloat162_rn(acc[mi][nj][2 * h] + b0,
                                  acc[mi][nj][2 * h + 1] + b1);
      }
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kBK8 = 64;        // int8 input channels per pipeline stage
constexpr int kLd8 = kBK8 + 16;  // byte row pitch in shared memory (80)

__global__ void __launch_bounds__(kThreads)
    conv3x3x3_int8_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ sw,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int D, int H,
                          int W, int C, int O, int M) {
  __shared__ __align__(128) int8_t sA[kStages][kBM * kLd8];
  __shared__ __align__(128) int8_t sB[kStages][kBN * kLd8];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_tiles = (O + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int cv = (tid % 4) * 16;  // this thread's 16-channel column

  int rb[4], rz[4], ry[4], rx[4];
  bool rok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / 4 + 32 * j;
    rok[j] = m < M;
    const int mm = rok[j] ? m : 0;
    rx[j] = mm % W;
    ry[j] = (mm / W) % H;
    rz[j] = (mm / (W * H)) % D;
    rb[j] = mm / (W * H * D);
  }

  const int kc = (C + kBK8 - 1) / kBK8;
  const int group = 9 * kc;  // iterations of one dx group
  const int iters = 3 * group;
  const long long wrow = 27LL * C;

  // tap index in packing order: tp = dx*9 + dz*3 + dy
  auto load_stage = [&](int stage, int it) {
    const int tp = it / kc;
    const int c = (it % kc) * kBK8 + cv;
    const int dx = tp / 9 - 1, dz = (tp / 3) % 3 - 1, dy = tp % 3 - 1;
    const bool cok = c < C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int z = rz[j] + dz, y = ry[j] + dy, xx = rx[j] + dx;
      const bool ok = cok && rok[j] && z >= 0 && z < D && y >= 0 && y < H &&
                      xx >= 0 && xx < W;
      const int8_t* src =
          ok ? x + ((((long long)rb[j] * D + z) * H + y) * W + xx) * C + c
             : x;
      cp_async16(&sA[stage][(tid / 4 + 32 * j) * kLd8 + cv], src, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = tid / 4 + 32 * j;
      const bool ok = cok && n0 + n < O;
      const int8_t* src =
          ok ? w + (long long)(n0 + n) * wrow + (long long)tp * C + c : w;
      cp_async16(&sB[stage][n * kLd8 + cv], src, ok);
    }
  };

  const int wm = (warp % 2) * 64, wn = (warp / 2) * 32;
  const int g = lane / 4, t = lane % 4;
  int acc[4][4][4];
  float accf[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        accf[i][j][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < iters) load_stage(nxt % kStages, nxt);
    cp_async_commit();

    const int8_t* a_s = sA[it % kStages];
    const int8_t* b_s = sB[it % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK8; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_s + (wm + mi * 16 + lane % 16) * kLd8 + kk +
                                (lane / 16) * 16);
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn + nj * 8 + lane % 8 + (lane / 16) * 8) *
                                 kLd8 +
                           kk + ((lane / 8) % 2) * 16);
        bf[nj][0] = r[0];
        bf[nj][1] = r[1];
        bf[nj + 1][0] = r[2];
        bf[nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_s8(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
    }

    if ((it + 1) % group == 0) {  // a dx group is complete: dequantize it
      const float* s_dx = sw + (long long)(it / group) * O;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn + nj * 8 + 2 * t;
        const float s0 = n < O ? s_dx[n] : 0.f;
        const float s1 = n < O ? s_dx[n + 1] : 0.f;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            accf[mi][nj][e] = __fadd_rn(
                accf[mi][nj][e],
                __fmul_rn(__int2float_rn(acc[mi][nj][e]), e % 2 ? s1 : s0));
            acc[mi][nj][e] = 0;
          }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int n = n0 + wn + nj * 8 + 2 * t;
    if (n >= O) continue;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * O + n) =
            __floats2bfloat162_rn(__fadd_rn(accf[mi][nj][2 * h], b0),
                                  __fadd_rn(accf[mi][nj][2 * h + 1], b1));
      }
    }
  }
}

}  // namespace

extern "C" {

int conv3x3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                   int B, int D, int H, int W, int C, int O, void* stream) {
  const long long M = (long long)B * D * H * W;
  const long long blocks = (M + kBM - 1) / kBM * ((O + kBN - 1) / kBN);
  if (M <= 0 || M >= (1LL << 31) || blocks >= (1LL << 31) || C % 8 || O % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  conv3x3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), D, H, W, C, O, static_cast<int>(M));
  return static_cast<int>(cudaGetLastError());
}

int conv3x3x3_int8(const void* x8, const void* w8, const void* sw,
                   const void* bias, void* out, int B, int D, int H, int W,
                   int C, int O, void* stream) {
  const long long M = (long long)B * D * H * W;
  const long long blocks = (M + kBM - 1) / kBM * ((O + kBN - 1) / kBN);
  if (M <= 0 || M >= (1LL << 31) || blocks >= (1LL << 31) || C % 32 ||
      O % 32 || sw == nullptr || bias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  conv3x3x3_int8_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x8), static_cast<const int8_t*>(w8),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), D, H, W, C, O, static_cast<int>(M));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
