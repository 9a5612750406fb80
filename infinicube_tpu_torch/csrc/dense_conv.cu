// Dense 3x3x3 stride-1 SAME convolution for Hopper (sm_90a), NDHWC, behind a
// plain C interface (loaded with ctypes by infinicube_tpu_torch/kernels).
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
//   with zeros outside the volume, f32 accumulation and bf16 output. C and O
//   are multiples of 8 (the caller zero-pads other widths).
//
// What bounds it: 2 * V * 27 * C * O bf16 operations against
// (V * (C + O) + 27 * C * O) * 2 bytes; at the UNet's widths that is
// thousands of operations per byte, so the bound is the tensor cores' 989
// TFLOP/s (H100 SXM), except at 8^3 where the 64 MB of weights take about as
// long to read as the products take to compute.
//
// Design: an implicit GEMM with M = output voxels, N = O, K = 27 * C in
// (tap, channel) order, on wgmma with TMA-fed shared memory. The first
// version (mma.sync on cp.async tiles) had four limits, and this design
// answers each:
// - mma.sync cannot reach Hopper's tensor-core rate: the products run on
//   wgmma m64nNk16 (bf16, f32 accumulators), two consumer warpgroups of 64
//   output voxels each against one N tile of up to 256 channels, fed by a
//   producer warp through a ring of 4-8 stages with mbarriers.
// - every A row was gathered by a thread, one 16-byte copy at a time, with
//   the halo tested in code: an M tile is a patch of 128 voxels (16 x 8 x 1
//   of x, y, z at W >= 16, 8 x 8 x 2 at 8^3), and for tap (dz, dy, dx) and a
//   box of channels its A tile is ONE TMA box of the 5-D tensor map of x
//   [B, D, H, W, C] at (b, z0+dz-1, y0+dy-1, x0+dx-1, c0). TMA fills what
//   lies outside the tensor with zeros, which is exactly the SAME halo; no
//   thread computes an address. The weight tile is one 2-D box of the packed
//   [O, 27*C] matrix. Boxes of 64 channels land under the 128-byte swizzle
//   that wgmma reads; C <= 32 (in_conv's 16) takes 32- or 16-channel boxes
//   under the 64- or 32-byte swizzle, so no narrow conv multiplies zeros.
//   Channels of a box past C read as zeros (and multiply the next tap's
//   weights, adding exact zeros).
// - small O re-gathered every A tile per 64 output channels: the N tile is
//   O itself up to 256 (192 covers O = 192 in one tile; 384 and 768 take 2
//   or 3 tiles), so an A tile is loaded once per 192-256 output channels.
// - too few blocks at 8^3 (48 blocks on 132 SMs, each walking K = 41,472
//   alone): where M tiles x N tiles fall short of the SM count (or leave a
//   few waves with a ragged last one), the K range is split into S slices
//   (S chosen so the grid fills whole waves); each
//   slice writes f32 partials to a scratch buffer [S, M, O] that the caller
//   allocates, and a second kernel adds the slices in a fixed order, then
//   the bias, then casts to bf16. No atomics: runs are bit-reproducible.
// Blocks run with the N tile fastest, then the M tile, then the slice, so
// that the blocks in flight share their A boxes and weight boxes in L2.
//
// conv3x3x3_f32 is the same function in f32 (f32 input, weights packed
// [O, 27*C] in f32, f32 output), for models that compute in f32 (the
// reference's Conv3x3x3 serves every dtype): a simple implicit GEMM on the
// CUDA cores with f32 FMA and f32 accumulation, 64 x 64 output tiles, 4 x 4
// per thread. Any C and O. It serves the forward pass and, with the flipped
// pack and no bias, the input gradient. Bounded by the f32 CUDA-core rate
// (67 TFLOP/s); built to be right, not fast.
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
//   reference does (t1 + t0, then + t2), then the bias, then bf16. C and O
//   are multiples of 32 (the caller zero-pads other widths).
//
// What bounds it: the same 2 * 27 * C * O operations per voxel as K3 on the
// int8 tensor cores (1,979 TOP/s on an H100 SXM), against (C + 2 * O) bytes.
//
// Design (a first, simple version): an implicit GEMM on int8 mma.sync
// m16n8k32, 128-voxel x 64-channel tiles, 4 warps, a 3-stage cp.async ring.
// The weights arrive packed [O, 27*C] int8 with k = (dx*9 + dz*3 + dy)*C + c,
// so K runs one dx group after the other; a stage holds 64 channels (64
// bytes a row), ldmatrix reads the byte tiles as b16 tiles (which is the s8
// fragment layout) and mma.sync m16n8k32 s8 accumulates into int32
// registers. At the end of each dx group the int32 sums are converted,
// scaled by sw[dx, o] and added into f32 registers (rounded multiply and
// add, no fused multiply-add, so the result equals the plain version's),
// and the int32 registers restart at 0.
//
// The entry points return cudaGetLastError() (or cudaErrorInvalidValue for
// what they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- K7's tiles and helpers ------------------------------------------------

constexpr int kBM = 128;      // output voxels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kStages = 3;
constexpr int kThreads = 128;

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


// ---- K3 on wgmma and TMA ---------------------------------------------------

constexpr int kK3Rows = 128;         // output voxels per tile
constexpr int kK3Threads = 288;      // warpgroups 0, 1 consume, warp 8 produces
constexpr int kK3Ring = 196608;      // bytes of shared memory for the ring

// BN output channels by BKC input channels (one box row of BKC bf16 is the
// swizzle span: 128, 64 or 32 bytes)
template <int BN, int BKC>
struct K3Tile {
  static constexpr int kSpan = BKC * 2;
  static constexpr int kStageA = kK3Rows * kSpan;
  static constexpr int kStage = kStageA + BN * kSpan;
  static constexpr int kStages = kK3Ring / kStage > 8 ? 8 : kK3Ring / kStage;
  // ring, its full and empty barriers, and room to align the ring to 1 KB
  static constexpr int kSmem = kStages * kStage + 2 * 8 * kStages + 1024;
};

struct K3Args {
  int D, H, W, C, O;
  int tw, th, td;          // the voxel patch of an M tile (tw*th*td = 128)
  int nx, ny, nz;          // patches along x, y, z
  int m_tiles, n_tiles;
  int kc;                  // channel boxes per tap
  int iters, per_split;    // K iterations in all; per slice
  long long M;             // output voxels
  const float* bias;       // f32 [O] or null
  __nv_bfloat16* out;      // bf16 [M, O] (one slice)
  float* partial;          // f32 [splits, M, O] (several slices), else null
};

template <int BN, int BKC>
__global__ void __launch_bounds__(kK3Threads, 1)
    conv3x3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                           const __grid_constant__ CUtensorMap tmw,
                           const K3Args a) {
  using T = K3Tile<BN, BKC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStage);
  uint64_t* empty = full + T::kStages;

  int bid = blockIdx.x;
  const int nt = bid % a.n_tiles;
  bid /= a.n_tiles;
  const int mt = bid % a.m_tiles;
  const int split = bid / a.m_tiles;
  const int x0 = (mt % a.nx) * a.tw;
  const int y0 = (mt / a.nx % a.ny) * a.th;
  const int z0 = (mt / (a.nx * a.ny) % a.nz) * a.td;
  const int b = mt / (a.nx * a.ny * a.nz);
  const int n0 = nt * BN;
  const int it0 = split * a.per_split;
  const int it1 = min(a.iters, it0 + a.per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tmx);
      hop::prefetch_map(&tmw);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = it0; it < it1; ++it) {
        hop::mbar_wait(&empty[stage], phase ^ 1);
        const int tap = it / a.kc;
        const int c0 = (it % a.kc) * BKC;
        const int dz = tap / 9, dy = tap / 3 % 3, dx = tap % 3;
        uint8_t* sa = ring + stage * T::kStage;
        hop::mbar_expect_tx(&full[stage], T::kStage);
        hop::tma_load_5d(sa, &tmx, &full[stage], c0, x0 + dx - 1,
                         y0 + dy - 1, z0 + dz - 1, b);
        hop::tma_load_2d(sa + T::kStageA, &tmw, &full[stage],
                         tap * a.C + c0, n0);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 output voxels each, all BN channels ----
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    constexpr int span = T::kSpan, sbo = 8 * T::kSpan;
    const int lane = threadIdx.x % 32;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int it = it0; it < it1; ++it) {
      hop::mbar_wait(&full[stage], phase);
      const uint8_t* sa = ring + stage * T::kStage + wg * 64 * span;
      const uint8_t* sb = ring + stage * T::kStage + T::kStageA;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKC / 16; ++kk)  // a k16 step is 32 bytes
        hop::Wgmma<BN>::ss(acc, hop::make_desc(sa + 32 * kk, span, 16, sbo),
                           hop::make_desc(sb + 32 * kk, span, 16, sbo), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the previous stage's products are done
      hop::fence_regs(acc);
      if (it > it0 && lane == 0) hop::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // ---- epilogue: bias and bf16, or the slice's f32 partials ----
    const int w = threadIdx.x % 128 / 32, g = lane / 4, q = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + w * 16 + g + 8 * h;
      const int x = x0 + r % a.tw, y = y0 + r / a.tw % a.th,
                z = z0 + r / (a.tw * a.th);
      if (x >= a.W || y >= a.H || z >= a.D) continue;
      const long long m = (((long long)b * a.D + z) * a.H + y) * a.W + x;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n >= a.O) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (a.partial != nullptr) {
          *reinterpret_cast<float2*>(
              a.partial + ((long long)split * a.M + m) * a.O + n) =
              make_float2(v0, v1);
        } else {
          const float b0 = a.bias ? a.bias[n] : 0.f;
          const float b1 = a.bias ? a.bias[n + 1] : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(a.out + m * a.O + n) =
              __floats2bfloat162_rn(v0 + b0, v1 + b1);
        }
      }
    }
  }
}

// out = bf16(((p[0] + p[1]) + ...) + bias), four outputs a thread.
__global__ void conv3x3x3_splitk_reduce(const float* __restrict__ partial,
                                        const float* __restrict__ bias,
                                        __nv_bfloat16* __restrict__ out,
                                        long long MO, int O, int splits) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= MO) return;
  float4 s = *reinterpret_cast<const float4*>(partial + i);
  for (int k = 1; k < splits; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(partial + k * MO + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  if (bias != nullptr) {
    const int n = static_cast<int>(i % O);
    s.x += bias[n];
    s.y += bias[n + 1];
    s.z += bias[n + 2];
    s.w += bias[n + 3];
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = v;
}

int pow2_at_least(int v, int cap) {
  int p = 1;
  while (p < v && p < cap) p *= 2;
  return p;
}

// The tiling of one K3 call: the voxel patch, the N tile, the channel box
// and the number of K slices (1 unless the tiles fall short of `sms`).
struct K3Plan {
  int tw, th, td, nx, ny, nz, m_tiles, bn, n_tiles, bkc, kc, iters, splits,
      per_split;
};

K3Plan k3_plan(int B, int D, int H, int W, int C, int O, int sms) {
  K3Plan p;
  p.tw = pow2_at_least(W, 16);
  p.th = pow2_at_least(H, kK3Rows / p.tw);
  p.td = kK3Rows / (p.tw * p.th);
  p.nx = (W + p.tw - 1) / p.tw;
  p.ny = (H + p.th - 1) / p.th;
  p.nz = (D + p.td - 1) / p.td;
  p.m_tiles = B * p.nx * p.ny * p.nz;
  if (O <= 256) {
    p.bn = O <= 16 ? 16 : O <= 32 ? 32 : O <= 64 ? 64 : O <= 128 ? 128
           : O <= 192 ? 192 : 256;
  } else {  // the widest tile that wastes least
    p.bn = 256;
    int best = (O + 255) / 256 * 256 - O;
    const int cands[2] = {192, 128};
    for (int bn : cands) {
      const int waste = (O + bn - 1) / bn * bn - O;
      if (waste < best) {
        best = waste;
        p.bn = bn;
      }
    }
  }
  p.n_tiles = (O + p.bn - 1) / p.bn;
  p.bkc = C <= 16 ? 16 : C <= 32 ? 32 : 64;
  p.kc = (C + p.bkc - 1) / p.bkc;
  p.iters = 27 * p.kc;
  p.splits = 1;
  const long long tiles = (long long)p.m_tiles * p.n_tiles;
  auto fill = [&](int s) {  // the share of the last wave's SMs kept busy
    const long long blocks = tiles * s;
    return static_cast<double>(blocks) /
           (static_cast<double>((blocks + sms - 1) / sms) * sms);
  };
  if (sms > 0 && tiles < sms) {
    // the fewest slices that fill 90 % of whole waves, else the fullest
    double best = 0.0;
    for (int s = 1; s <= 16 && s <= p.iters / 8; ++s) {
      if (fill(s) > best + 1e-9) {
        best = fill(s);
        p.splits = s;
      }
      if (best >= 0.9) break;
    }
  } else if (sms > 0 && tiles < 4 * sms) {
    // a few waves with a ragged last one: 2 or 3 slices where they fill
    // the waves markedly better
    for (int s = 2; s <= 3 && s <= p.iters / 8; ++s)
      if (fill(s) >= fill(p.splits) + 0.15) p.splits = s;
  }
  p.per_split = (p.iters + p.splits - 1) / p.splits;
  p.splits = (p.iters + p.per_split - 1) / p.per_split;  // none left empty
  return p;
}

template <int BN, int BKC>
cudaError_t launch_k3(const CUtensorMap& tmx, const CUtensorMap& tmw,
                      const K3Args& args, unsigned blocks,
                      cudaStream_t stream) {
  using T = K3Tile<BN, BKC>;
  static cudaError_t attr =
      hop_host::allow_smem(conv3x3x3_wgmma_kernel<BN, BKC>, T::kSmem);
  if (attr != cudaSuccess) return attr;
  conv3x3x3_wgmma_kernel<BN, BKC>
      <<<blocks, kK3Threads, T::kSmem, stream>>>(tmx, tmw, args);
  return cudaGetLastError();
}

template <int BKC>
cudaError_t launch_k3_bn(int bn, const CUtensorMap& tmx,
                         const CUtensorMap& tmw, const K3Args& args,
                         unsigned blocks, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch_k3<16, BKC>(tmx, tmw, args, blocks, stream);
    case 32: return launch_k3<32, BKC>(tmx, tmw, args, blocks, stream);
    case 64: return launch_k3<64, BKC>(tmx, tmw, args, blocks, stream);
    case 128: return launch_k3<128, BKC>(tmx, tmw, args, blocks, stream);
    case 192: return launch_k3<192, BKC>(tmx, tmw, args, blocks, stream);
    default: return launch_k3<256, BKC>(tmx, tmw, args, blocks, stream);
  }
}

// One K3 call: `partial` null and splits 1, or f32 [splits, M, O] scratch.
int run_k3(const void* x, const void* w, const void* bias, void* out,
           void* partial, int splits, int B, int D, int H, int W, int C,
           int O, int sms, void* stream) {
  const long long M = (long long)B * D * H * W;
  if (M <= 0 || M >= (1LL << 31) || C <= 0 || O <= 0 || C % 8 || O % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || (splits > 1) != (partial != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  K3Plan p = k3_plan(B, D, H, W, C, O, sms);
  if (p.splits != splits) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)p.m_tiles * p.n_tiles * p.splits;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap tmx, tmw;
  const uint64_t xd[5] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)D,
                          (uint64_t)B};
  const uint64_t xs[4] = {(uint64_t)C * 2, (uint64_t)W * C * 2,
                          (uint64_t)H * W * C * 2,
                          (uint64_t)D * H * W * C * 2};
  const uint32_t xb[5] = {(uint32_t)p.bkc, (uint32_t)p.tw, (uint32_t)p.th,
                          (uint32_t)p.td, 1};
  const uint64_t wd[2] = {(uint64_t)27 * C, (uint64_t)O};
  const uint64_t ws[1] = {(uint64_t)27 * C * 2};
  const uint32_t wb[2] = {(uint32_t)p.bkc, (uint32_t)p.bn};
  if (!hop_host::make_map(&tmx, x, 5, xd, xs, xb, p.bkc * 2) ||
      !hop_host::make_map(&tmw, w, 2, wd, ws, wb, p.bkc * 2))
    return static_cast<int>(cudaErrorInvalidValue);

  K3Args a;
  a.D = D; a.H = H; a.W = W; a.C = C; a.O = O;
  a.tw = p.tw; a.th = p.th; a.td = p.td;
  a.nx = p.nx; a.ny = p.ny; a.nz = p.nz;
  a.m_tiles = p.m_tiles; a.n_tiles = p.n_tiles;
  a.kc = p.kc; a.iters = p.iters; a.per_split = p.per_split;
  a.M = M;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaError_t e =
      p.bkc == 64   ? launch_k3_bn<64>(p.bn, tmx, tmw, a, nb, st)
      : p.bkc == 32 ? launch_k3_bn<32>(p.bn, tmx, tmw, a, nb, st)
                    : launch_k3_bn<16>(p.bn, tmx, tmw, a, nb, st);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long MO = M * O;
  const long long threads = MO / 4;
  conv3x3x3_splitk_reduce<<<static_cast<unsigned>((threads + 255) / 256),
                            256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), MO, O, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---- conv3x3x3_f32: the f32 conv on the CUDA cores --------------------------

constexpr int kF32Tile = 64;   // output voxels and channels per block
constexpr int kF32K = 16;      // input channels per step

__global__ void __launch_bounds__(256)
    conv3x3x3_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int D, int H, int W, int C,
                         int O, long long M, int n_tiles) {
  __shared__ float sA[kF32K][kF32Tile + 4];  // [k][voxel]
  __shared__ float sB[kF32K][kF32Tile + 4];  // [k][output channel]
  const int tid = threadIdx.x;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kF32Tile;
  const int n0 = (blockIdx.x % n_tiles) * kF32Tile;
  const int ty = tid / 16, tx = tid % 16;
  const long long wrow = 27LL * C;
  float acc[4][4] = {};

  // the voxels this thread stages: rows tid / 16 + 16 j, channel tid % 16
  int vb[4], vz[4], vy[4], vx[4];
  bool vok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long m = m0 + tid / 16 + 16 * j;
    vok[j] = m < M;
    const long long mm = vok[j] ? m : 0;
    vx[j] = static_cast<int>(mm % W);
    vy[j] = static_cast<int>(mm / W % H);
    vz[j] = static_cast<int>(mm / ((long long)W * H) % D);
    vb[j] = static_cast<int>(mm / ((long long)W * H * D));
  }
  const int kc = (C + kF32K - 1) / kF32K;
  for (int it = 0; it < 27 * kc; ++it) {
    const int tap = it / kc;
    const int c = (it % kc) * kF32K + tid % 16;
    const int dz = tap / 9 - 1, dy = tap / 3 % 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int z = vz[j] + dz, y = vy[j] + dy, xx = vx[j] + dx;
      const bool ok = vok[j] && c < C && z >= 0 && z < D && y >= 0 &&
                      y < H && xx >= 0 && xx < W;
      sA[tid % 16][tid / 16 + 16 * j] =
          ok ? x[((((long long)vb[j] * D + z) * H + y) * W + xx) * C + c]
             : 0.f;
      const int n = n0 + tid / 16 + 16 * j;
      sB[tid % 16][tid / 16 + 16 * j] =
          (n < O && c < C) ? w[n * wrow + (long long)tap * C + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sA[k][ty * 4 + i];
        bv[i] = sB[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < O) out[m * O + n] = acc[i][j] + (bias ? bias[n] : 0.f);
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

// The number of K slices K3 takes on a card with `sms` SMs.
int conv3x3x3_bf16_splits(int B, int D, int H, int W, int C, int O, int sms) {
  return k3_plan(B, D, H, W, C, O, sms).splits;
}

// K3 on a card with `sms` SMs, its K range in `splits` slices as
// conv3x3x3_bf16_splits gives them: with one, `partial` is null; with more,
// it is f32 [splits, B*D*H*W, O] scratch, and the fixed-order sum of the
// slices, the bias and the bf16 cast follow.
int conv3x3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                   void* partial, int splits, int B, int D, int H, int W,
                   int C, int O, int sms, void* stream) {
  return run_k3(x, w, bias, out, partial, splits, B, D, H, W, C, O, sms,
                stream);
}

int conv3x3x3_f32(const void* x, const void* w, const void* bias, void* out,
                  int B, int D, int H, int W, int C, int O, void* stream) {
  const long long M = (long long)B * D * H * W;
  const int n_tiles = (O + kF32Tile - 1) / kF32Tile;
  const long long blocks = (M + kF32Tile - 1) / kF32Tile * n_tiles;
  if (M <= 0 || C <= 0 || O <= 0 || blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  conv3x3x3_f32_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), D, H, W, C,
      O, M, n_tiles);
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
