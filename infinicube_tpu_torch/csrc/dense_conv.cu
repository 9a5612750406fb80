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
// conv3x3x3_int8 (K7) replaces the int8 branch of the same TPU kernel
//   (`_pallas_conv` with `swx`, dense_conv.py:136-174), which serves the
//   UNet's convs under `DiffusionConfig.serve_quant` where the reference's
//   plan fits (23 of the 48 at release). x arrives as int8 with one scale
//   per input channel folded into the int8 weights, which carry one f32
//   scale per (dx, output channel), sw [3, O]:
//   out[v, o] = bf16((((f32(S0) * sw[0,o]) + f32(S1) * sw[1,o])
//                     + f32(S2) * sw[2,o]) + bias[o])
//   where S_dx = sum_{dz, dy, c} x8 * w8 is exact in int32, every product
//   and sum rounded once (no fused multiply-add), which equals the
//   reference's (t1 + t0) + t2 bit for bit. C and O are multiples of 32
//   (the caller zero-pads other widths).
// What bounds it: the same 2 * 27 * C * O operations per voxel as K3 on the
// int8 tensor cores (1,979 TOP/s on an H100 SXM), against (C + 2 * O) bytes.
// Design: K7 is the int8 instantiation of K3's kernel (one pipeline): the
// same 128-voxel patches, 5-D TMA boxes of x8 whose zero fill is the halo,
// one 2-D box of the packed weights, the producer warp and mbarrier ring,
// and wgmma m64nNk32 .s32.s8.s8 (8-bit wgmma has no transpose bit, so both
// operands are K-major: x8's channels and the pack's k are contiguous). The
// pack orders K dx-major, k = (dx*9 + dz*3 + dy)*C + c, so each dx group is
// one contiguous third of K: at its end the consumers wait for their
// products, convert the int32 sums, scale them by sw[dx] and add them into
// an f32 running sum, and the next group's first products overwrite the
// int32 sums (wgmma's scale-d 0, no thread writes them). Both sums live in
// registers, so the N tile stays at 128 or below (BN/2 int32 and BN/2 f32
// a thread: 128 registers at BN = 128) and no setmaxnreg is needed. ptxas
// still serializes K7's wgmmas (C7515) while the conversion multiplies by
// a scale (without that multiply it does not); the cause is not found. A
// box row of 128 int8 channels is the 128-byte swizzle span, 64 and 32 the
// 64- and 32-byte spans (the widest that pads C by at most an eighth).
// Split K keeps the result
// exact: slices never straddle a dx group, each writes its int32 sums, and
// the reduce adds the slices of a group as integers (exact in any order),
// then scales and adds the three groups and the bias as above.
//
// The quantize prologue (the reference's `_quantize_for_conv`,
// dense_conv.py:251, XLA outside its pallas_call) runs in three kernels:
// int8_conv_amax (one read of x: per-channel max |x| over the whole batch,
// as an unsigned max on the bits of non-negative floats, exact in any
// order), int8_conv_quantize_x (a second read of x: x8 = rint(x / sc) at
// the width padded to 32) and int8_conv_quantize_w (the weights rounded to
// bf16, folded with sc, their per-(dx, o) scales and the padded dx-major
// pack). Each divides where the reference divides (IEEE division, never a
// reciprocal) and rounds half to even, so x8, the pack and sw equal the
// plain prologue's bit for bit. Bounded by bytes: x read once by each of
// the first two, the weights read once (f32: 4 bytes a value) and the
// int8 pack written once by the third. amax and the weight pass read with
// coalesced 16-byte loads, reduce across blocks without contended atomics,
// and the weight pass writes the pack in 16-byte stores through a
// transpose in shared memory (the designs at each kernel below).
//
// conv3x3x3_f32 is the same function in f32 (f32 input and output), for
// models that compute in f32 (the reference's Conv3x3x3 serves every
// dtype): an f32 release UNet runs 48 of them a call. It serves the forward
// pass and, with the flipped, swapped pack and no bias, the input gradient.
// C and O are multiples of 8 (the caller zero-pads other widths).
// What bounds it: 2 * V * 27 * C * O f32 operations. On the CUDA cores (67
// TFLOP/s) the first version, a 64 x 64 FFMA tile a block with the halo
// staged element by element, reached 27-31 % of that and lost to cuDNN's f32
// conv. Design: the f32 instantiation of K3's kernel on the tensor cores by
// the 3xTF32 split, as K4 (sparse_conv.cu) does: a = hi + lo with hi =
// tf32(a) (the low 13 mantissa bits cleared) and lo = tf32(a - hi), and
// each product taken as lo_A hi_B + hi_A lo_B + hi_A hi_B on wgmma m64nNk8
// .f32.tf32.tf32 with f32 accumulators (lo_A lo_B, about 2^-22 of it, is
// dropped); three products at 495 TFLOP/s bound it at 165 TFLOP/s of f32
// work. The weights come packed [2, O, 27*C], their hi and lo made once per
// weight version by the caller, two 2-D TMA boxes a stage; x comes as one
// 5-D TMA box a tap as for K3 (32 channels, 128 bytes: the 128-byte
// swizzle; 16 or 8 channels under the 64- or 32-byte one where C is 16 or
// 8). The consumers split their own 64 rows of each arrived A tile, hi in
// place and lo into one of two buffers of their own (the previous stage's
// products may still read the other), fence the writes to the async proxy
// and issue the three products per k8 step. The tensor cores truncate every
// sum they accumulate (round toward zero), which drifts over a long K (2.5e-4
// of max|out| at K = 27 * 1,152 in one accumulator), so every 32 k8 steps
// the consumers wait for their products, add the wgmma sums into f32 sums
// with a rounded add and restart them (scale-d 0), as K7 does for its dx
// groups. Both sums live in registers: the producer is a warpgroup whose
// registers go to the consumers (setmaxnreg, 240 each), which holds an N
// tile of 192 (192 registers of sums). The small-M shapes split K with f32
// partials summed in slice order, as K3.
//
// The entry points return cudaGetLastError() (or cudaErrorInvalidValue for
// what they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---- K3, K7 and the f32 conv on wgmma and TMA -------------------------------

constexpr int kConvRows = 128;       // output voxels per tile
constexpr int kConvThreads = 288;    // warpgroups 0, 1 consume, warp 8 produces
// the f32 conv: a producer warpgroup instead of a warp, so that setmaxnreg
// can hand its registers to the consumers (as K2): 24 left to it, 240 to
// each consumer thread, from the pool of a 168-register launch
constexpr int kF32Threads = 384;
constexpr int kF32ProducerRegs = 24, kF32ConsumerRegs = 240,
              kF32LaunchRegs = 168;
constexpr int kConvRing = 196608;    // bytes of shared memory for the ring

// the element type of one instantiation: bf16 (K3), int8 (K7), or f32 run
// as 3xTF32 (the f32 conv)
enum ConvElem { kBf16, kS8, kF32 };

// BN output channels by one box row of SPAN bytes (the swizzle span: 128, 64
// or 32) of E elements
template <int E, int BN, int SPAN>
struct ConvTile {
  static constexpr bool kInt8 = E == kS8, kTf32 = E == kF32;
  static constexpr int kThreads = kTf32 ? kF32Threads : kConvThreads;
  static constexpr int kBoxC = SPAN / (kInt8 ? 1 : kTf32 ? 4 : 2);
  static constexpr int kStageA = kConvRows * SPAN;
  static constexpr int kStageB = BN * SPAN;  // one weight box (f32: hi, lo)
  static constexpr int kStage = kStageA + (kTf32 ? 2 : 1) * kStageB;
  static constexpr int kStages =
      kConvRing / kStage > 8 ? 8 : kConvRing / kStage;
  // f32: the lo parts of A, two buffers of 64 rows per consumer warpgroup
  static constexpr int kLo = kTf32 ? 4 * 64 * SPAN : 0;
  // ring, lo buffers, the ring's full and empty barriers, K7's scales
  // sw[3][BN] of the N tile, and room to align the ring to 1 KB
  static constexpr int kSmem = kStages * kStage + kLo + 2 * 8 * kStages +
                               (kInt8 ? 12 * BN : 0) + 1024;
};

struct ConvArgs {
  int D, H, W, C, O;
  int tw, th, td;          // the voxel patch of an M tile (tw*th*td = 128)
  int nx, ny, nz;          // patches along x, y, z
  int m_tiles, n_tiles;
  int kc;                  // channel boxes per tap
  int group, sg;           // K iterations of a group of slices; its slices
  int per_split;           // K iterations per slice
  int dx_iters;            // K7: K iterations of one dx group
  int flush;               // f32: K iterations between flushes of the sums
  long long M;             // output voxels
  const float* bias;       // f32 [O] or null (K3's dgrad)
  const float* sw;         // K7: f32 [3, O]
  void* out;               // [M, O], bf16 (K3, K7) or f32 (one slice)
  void* partial;           // [splits, M, O] f32 (K3, f32) or int32 (K7), or
                           // null
};

__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

// v = hi + lo up to lo's own truncation: hi = tf32(v), lo = tf32(v - hi)
// (v - hi is exact)
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = tf32_trunc(v);
  lo = tf32_trunc(v - hi);
}

// tmw_lo: the f32 pack's lo half (K3 and K7 are handed tmw again and read
// nothing from it)
template <int E, int BN, int SPAN>
__global__ void __launch_bounds__(ConvTile<E, BN, SPAN>::kThreads, 1)
    conv3x3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                           const __grid_constant__ CUtensorMap tmw,
                           const __grid_constant__ CUtensorMap tmw_lo,
                           const ConvArgs a) {
  using T = ConvTile<E, BN, SPAN>;
  constexpr bool kInt8 = T::kInt8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* lo_bufs = ring + T::kStages * T::kStage;  // f32: [wg][2][64 rows]
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_bufs + T::kLo);
  uint64_t* empty = full + T::kStages;
  float* s_sw = reinterpret_cast<float*>(empty + T::kStages);  // K7

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
  // slices come in groups (K7: one per dx group); a slice never leaves its
  // group
  const int grp = split / a.sg;
  const int it0 = grp * a.group + split % a.sg * a.per_split;
  const int it1 = min(grp * a.group + a.group, it0 + a.per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  if constexpr (kInt8) {
    // the tile's dequantization scales, staged once for the three dx groups
    for (int i = threadIdx.x; i < 3 * BN; i += blockDim.x) {
      const int n = n0 + i % BN;
      s_sw[i] = n < a.O ? a.sw[(long long)(i / BN) * a.O + n] : 0.f;
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    if constexpr (T::kTf32) hop::setmaxnreg_dec<kF32ProducerRegs>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tmx);
      hop::prefetch_map(&tmw);
      if constexpr (T::kTf32) hop::prefetch_map(&tmw_lo);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = it0; it < it1; ++it) {
        hop::mbar_wait(&empty[stage], phase ^ 1);
        // the tap in packing order: K3 dz-major, K7 dx-major
        const int tap = it / a.kc;
        const int c0 = (it % a.kc) * T::kBoxC;
        const int dz = kInt8 ? tap / 3 % 3 : tap / 9;
        const int dy = kInt8 ? tap % 3 : tap / 3 % 3;
        const int dx = kInt8 ? tap / 9 : tap % 3;
        uint8_t* sa = ring + stage * T::kStage;
        hop::mbar_expect_tx(&full[stage], T::kStage);
        hop::tma_load_5d(sa, &tmx, &full[stage], c0, x0 + dx - 1,
                         y0 + dy - 1, z0 + dz - 1, b);
        hop::tma_load_2d(sa + T::kStageA, &tmw, &full[stage],
                         tap * a.C + c0, n0);
        if constexpr (T::kTf32)
          hop::tma_load_2d(sa + T::kStageA + T::kStageB, &tmw_lo,
                           &full[stage], tap * a.C + c0, n0);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 output voxels each, all BN channels ----
    if constexpr (T::kTf32) hop::setmaxnreg_inc<kF32ConsumerRegs>();
    using Acc = typename std::conditional<kInt8, int, float>::type;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    // K7: the f32 sum of the dequantized dx groups so far; f32: of the
    // flushed groups
    constexpr bool kSum = kInt8 || T::kTf32;
    float sum[kSum ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < (kSum ? BN / 2 : 1); ++i) sum[i] = 0.f;
    constexpr int sbo = 8 * SPAN;
    const int lane = threadIdx.x % 32;
    const int q = lane % 4;
    // K7 without a split walks its three dx groups one after the other: the
    // first products of a group overwrite the int32 sums (scale-d 0), and
    // after its last the sums are converted outside the loop, so no thread
    // writes an accumulator while wgmmas are in flight. The f32 conv walks
    // groups of `flush` iterations alike and adds each group's sums into
    // `sum` with a rounded f32 add: the tensor cores truncate (round toward
    // zero) every sum they accumulate, and over K = 27 * 1,152 that drift
    // reached 2.5e-4 of max|out| in one accumulator.
    const bool by_group = (kInt8 && a.partial == nullptr) || T::kTf32;
    const int group_len = T::kTf32 ? a.flush : a.dx_iters;
    int stage = 0, prev = 0, lo_sel = 0;
    uint32_t phase = 0;
    for (int g0 = it0; g0 < it1;) {
      const int g1 =
          by_group ? min(it1, (g0 / group_len + 1) * group_len) : it1;
      for (int it = g0; it < g1; ++it) {
        hop::mbar_wait(&full[stage], phase);
        uint8_t* sa = ring + stage * T::kStage + wg * 64 * SPAN;
        const uint8_t* sb = ring + stage * T::kStage + T::kStageA;
        uint8_t* sl = lo_bufs + (wg * 2 + lo_sel) * 64 * SPAN;
        if constexpr (T::kTf32) {
          // this warpgroup's 64 rows: hi in place, lo into its buffer (the
          // swizzle is the same in both, so elementwise work ignores it)
          float4* ahi = reinterpret_cast<float4*>(sa);
          float4* alo = reinterpret_cast<float4*>(sl);
#pragma unroll
          for (int j = 0; j < SPAN / 32; ++j) {
            const int i = threadIdx.x % 128 + 128 * j;
            const float4 v = ahi[i];
            float4 h, l;
            split_tf32(v.x, h.x, l.x);
            split_tf32(v.y, h.y, l.y);
            split_tf32(v.z, h.z, l.z);
            split_tf32(v.w, h.w, l.w);
            ahi[i] = h;
            alo[i] = l;
          }
          hop::fence_proxy_async();
          hop::named_barrier(1 + wg, 128);
          lo_sel ^= 1;
        }
        hop::fence_regs(acc);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SPAN / 32; ++kk) {  // a k step is 32 bytes
          const uint64_t da = hop::make_desc(sa + 32 * kk, SPAN, 16, sbo);
          const uint64_t db = hop::make_desc(sb + 32 * kk, SPAN, 16, sbo);
          if constexpr (kInt8) {
            hop::WgmmaS8<BN>::ss(acc, da, db,
                                 by_group && kk == 0 && it == g0 ? 0 : 1);
          } else if constexpr (T::kTf32) {
            const uint64_t dl = hop::make_desc(sl + 32 * kk, SPAN, 16, sbo);
            const uint64_t dbl =
                hop::make_desc(sb + T::kStageB + 32 * kk, SPAN, 16, sbo);
            // the small terms first
            hop::WgmmaTf32<BN>::ss(acc, dl, db, kk == 0 && it == g0 ? 0 : 1);
            hop::WgmmaTf32<BN>::ss(acc, da, dbl, 1);
            hop::WgmmaTf32<BN>::ss(acc, da, db, 1);
          } else {
            hop::Wgmma<BN>::ss(acc, da, db, 1);
          }
        }
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
      if constexpr (kInt8) {
        if (by_group) {
          // a dx group is complete: sum += f32(S) * sw[dx]
          hop::wgmma_wait<0>();
          hop::fence_regs(acc);
          const float* s_dx = s_sw + (g0 / a.dx_iters) * BN;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float s0 = s_dx[8 * j + 2 * q];
            const float s1 = s_dx[8 * j + 2 * q + 1];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sum[4 * j + e] = __fadd_rn(
                  sum[4 * j + e],
                  __fmul_rn(__int2float_rn(acc[4 * j + e]), e % 2 ? s1 : s0));
          }
        }
      } else if constexpr (T::kTf32) {
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
      g0 = g1;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // ---- epilogue: bias and bf16, or the slice's partial sums ----
    const int w = threadIdx.x % 128 / 32, g = lane / 4;
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
        Acc v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (T::kTf32) {
          v0 = sum[4 * j + 2 * h];
          v1 = sum[4 * j + 2 * h + 1];
        }
        const long long at = ((long long)split * a.M + m) * a.O + n;
        if (a.partial != nullptr) {
          if constexpr (kInt8)
            *reinterpret_cast<int2*>(static_cast<int*>(a.partial) + at) =
                make_int2(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.partial) + at) =
                make_float2(v0, v1);
        } else if constexpr (kInt8) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + m * a.O + n) =
              __floats2bfloat162_rn(
                  __fadd_rn(sum[4 * j + 2 * h], a.bias[n]),
                  __fadd_rn(sum[4 * j + 2 * h + 1], a.bias[n + 1]));
        } else {
          const float b0 = a.bias ? a.bias[n] : 0.f;
          const float b1 = a.bias ? a.bias[n + 1] : 0.f;
          if constexpr (T::kTf32)
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) +
                                       m * a.O + n) =
                make_float2(v0 + b0, v1 + b1);
          else
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.out) + m * a.O + n) =
                __floats2bfloat162_rn(v0 + b0, v1 + b1);
        }
      }
    }
  }
}

// K3 and the f32 conv: out = ((p[0] + p[1]) + ...) + bias, as bf16 or f32,
// four outputs a thread.
template <typename TO>
__global__ void conv3x3x3_splitk_reduce(const float* __restrict__ partial,
                                        const float* __restrict__ bias,
                                        TO* __restrict__ out,
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
  if constexpr (std::is_same<TO, float>::value) {
    *reinterpret_cast<float4*>(out + i) = s;
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + i) = v;
  }
}

// K7: S_dx = the int32 sum of dx group's `sg` slices (exact in any order),
// then out = bf16((((f32(S0) * sw0) + f32(S1) * sw1) + f32(S2) * sw2) +
// bias), every operation rounded once; four outputs a thread.
__global__ void conv3x3x3_int8_splitk_reduce(const int* __restrict__ partial,
                                             const float* __restrict__ sw,
                                             const float* __restrict__ bias,
                                             __nv_bfloat16* __restrict__ out,
                                             long long MO, int O, int sg) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= MO) return;
  const int n = static_cast<int>(i % O);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  for (int dx = 0; dx < 3; ++dx) {
    int4 s = *reinterpret_cast<const int4*>(partial + dx * sg * MO + i);
    for (int k = 1; k < sg; ++k) {
      const int4 p =
          *reinterpret_cast<const int4*>(partial + (dx * sg + k) * MO + i);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const int si[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[e] = __fadd_rn(t[e],
                       __fmul_rn(__int2float_rn(si[e]), sw[dx * O + n + e]));
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(__fadd_rn(t[0], bias[n]),
                                            __fadd_rn(t[1], bias[n + 1]));
  __nv_bfloat162 hi = __floats2bfloat162_rn(__fadd_rn(t[2], bias[n + 2]),
                                            __fadd_rn(t[3], bias[n + 3]));
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

// The tiling of one K3 or K7 call: the voxel patch, the N tile, the box row
// (span, bytes), the K iterations and how they are split into slices (1
// unless the tiles fall short of `sms`).
struct ConvPlan {
  int tw, th, td, nx, ny, nz, m_tiles, bn, n_tiles, span, kc, iters, group,
      sg, splits, per_split;
};

void plan_patch(ConvPlan& p, int B, int D, int H, int W) {
  p.tw = pow2_at_least(W, 16);
  p.th = pow2_at_least(H, kConvRows / p.tw);
  p.td = kConvRows / (p.tw * p.th);
  p.nx = (W + p.tw - 1) / p.tw;
  p.ny = (H + p.th - 1) / p.th;
  p.nz = (D + p.td - 1) / p.td;
  p.m_tiles = B * p.nx * p.ny * p.nz;
}

// The share of the last wave's SMs kept busy by `tiles` x `s` blocks.
double wave_fill(long long tiles, int s, int sms) {
  const long long blocks = tiles * s;
  return static_cast<double>(blocks) /
         (static_cast<double>((blocks + sms - 1) / sms) * sms);
}

// The number of slices among `cands` (ascending, cands[0] == 1) for
// `tiles` output tiles: where they fall short of the SMs, the fewest that
// fill 90 % of whole waves, else the fullest; where they make a few waves
// with a ragged last one, the next candidate if it fills them markedly
// better (up to 3 slices).
int choose_splits(long long tiles, int sms, const int* cands, int n) {
  int splits = 1;
  if (sms > 0 && tiles < sms) {
    double best = 0.0;
    for (int i = 0; i < n; ++i) {
      const double f = wave_fill(tiles, cands[i], sms);
      if (f > best + 1e-9) {
        best = f;
        splits = cands[i];
      }
      if (best >= 0.9) break;
    }
  } else if (sms > 0 && tiles < 4 * sms) {
    for (int i = 1; i < n && cands[i] <= 3; ++i)
      if (wave_fill(tiles, cands[i], sms) >=
          wave_fill(tiles, splits, sms) + 0.15)
        splits = cands[i];
  }
  return splits;
}

ConvPlan k3_plan(int B, int D, int H, int W, int C, int O, int sms) {
  ConvPlan p;
  plan_patch(p, B, D, H, W);
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
  const int bkc = C <= 16 ? 16 : C <= 32 ? 32 : 64;
  p.span = 2 * bkc;
  p.kc = (C + bkc - 1) / bkc;
  p.iters = 27 * p.kc;
  int cands[16];
  int n = 0;
  for (int s = 1; s <= 16 && s <= p.iters / 8; ++s) cands[n++] = s;
  if (n == 0) cands[n++] = 1;
  const int s = choose_splits((long long)p.m_tiles * p.n_tiles, sms, cands, n);
  p.per_split = (p.iters + s - 1) / s;
  p.splits = (p.iters + p.per_split - 1) / p.per_split;  // none left empty
  p.group = p.iters;
  p.sg = p.splits;
  return p;
}

// The f32 conv: the N tile (<= 192: the wgmma sums and the flushed f32
// sums share the consumers' 240 registers) that costs least, counting an A
// tile's reload as 32 more channels, as K7's; box rows of 32 channels (8 or
// 16 where C is that narrow); K split as K3's.
ConvPlan kf_plan(int B, int D, int H, int W, int C, int O, int sms) {
  ConvPlan p;
  plan_patch(p, B, D, H, W);
  p.bn = 128;
  int best = 1 << 30;
  const int cands_n[6] = {192, 128, 96, 64, 32, 16};
  for (int bn : cands_n) {
    const int cost = (O + bn - 1) / bn * (bn + 32);
    if (cost < best) {
      best = cost;
      p.bn = bn;
    }
  }
  p.n_tiles = (O + p.bn - 1) / p.bn;
  const int bkc = C <= 8 ? 8 : C <= 16 ? 16 : 32;
  p.span = 4 * bkc;
  p.kc = (C + bkc - 1) / bkc;
  p.iters = 27 * p.kc;
  int cands[16];
  int n = 0;
  for (int s = 1; s <= 16 && s <= p.iters / 8; ++s) cands[n++] = s;
  if (n == 0) cands[n++] = 1;
  const int s = choose_splits((long long)p.m_tiles * p.n_tiles, sms, cands, n);
  p.per_split = (p.iters + s - 1) / s;
  p.splits = (p.iters + p.per_split - 1) / p.per_split;  // none left empty
  p.group = p.iters;
  p.sg = p.splits;
  return p;
}

ConvPlan k7_plan(int B, int D, int H, int W, int C, int O, int sms) {
  ConvPlan p;
  plan_patch(p, B, D, H, W);
  // the N tile (<= 128: the int32 and the f32 sums share the registers)
  // that costs least, counting an A tile's reload as 32 more channels
  p.bn = 128;
  int best = 1 << 30;
  const int cands_n[4] = {128, 96, 64, 32};
  for (int bn : cands_n) {
    const int cost = (O + bn - 1) / bn * (bn + 32);
    if (cost < best) {
      best = cost;
      p.bn = bn;
    }
  }
  p.n_tiles = (O + p.bn - 1) / p.bn;
  // the widest box row (int8: bytes = channels) that pads C by at most an
  // eighth: the padded channels read zeros from TMA and cost products
  p.span = 32;
  for (int span : {128, 64})
    if ((C + span - 1) / span * span - C <= C / 8) {
      p.span = span;
      break;
    }
  p.kc = (C + p.span - 1) / p.span;
  p.iters = 27 * p.kc;
  const int dx_iters = 9 * p.kc;
  // 1 slice, or 3 x sg: sg slices in each dx group
  int cands[17];
  int n = 0;
  cands[n++] = 1;
  for (int sg = 1; sg <= 16 && sg <= dx_iters / 8; ++sg) cands[n++] = 3 * sg;
  const int s = choose_splits((long long)p.m_tiles * p.n_tiles, sms, cands, n);
  if (s == 1) {
    p.group = p.iters;
    p.sg = 1;
    p.per_split = p.iters;
    p.splits = 1;
  } else {
    p.group = dx_iters;
    p.per_split = (dx_iters + s / 3 - 1) / (s / 3);
    p.sg = (dx_iters + p.per_split - 1) / p.per_split;  // none left empty
    p.splits = 3 * p.sg;
  }
  return p;
}

template <int E, int BN, int SPAN>
cudaError_t launch_conv(const CUtensorMap& tmx, const CUtensorMap& tmw,
                        const CUtensorMap& tmw_lo, const ConvArgs& args,
                        unsigned blocks, cudaStream_t stream) {
  using T = ConvTile<E, BN, SPAN>;
  static cudaError_t attr = hop_host::allow_smem(
      conv3x3x3_wgmma_kernel<E, BN, SPAN>, T::kSmem);
  if (attr != cudaSuccess) return attr;
  if constexpr (T::kTf32) {
    // the consumers' setmaxnreg.inc needs the pool of a 168-register launch
    static const int regs = [] {
      cudaFuncAttributes fa;
      return cudaFuncGetAttributes(&fa, conv3x3x3_wgmma_kernel<E, BN, SPAN>) ==
                     cudaSuccess
                 ? fa.numRegs
                 : 0;
    }();
    if (regs < kF32LaunchRegs) return cudaErrorInvalidConfiguration;
  }
  conv3x3x3_wgmma_kernel<E, BN, SPAN>
      <<<blocks, T::kThreads, T::kSmem, stream>>>(tmx, tmw, tmw_lo, args);
  return cudaGetLastError();
}

template <int SPAN>
cudaError_t launch_k3_bn(int bn, const CUtensorMap& tmx,
                         const CUtensorMap& tmw, const ConvArgs& args,
                         unsigned blocks, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch_conv<kBf16, 16, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    case 32: return launch_conv<kBf16, 32, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    case 64: return launch_conv<kBf16, 64, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    case 128: return launch_conv<kBf16, 128, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    case 192: return launch_conv<kBf16, 192, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    default: return launch_conv<kBf16, 256, SPAN>(tmx, tmw, tmw, args, blocks, stream);
  }
}

template <int SPAN>
cudaError_t launch_k7_bn(int bn, const CUtensorMap& tmx,
                         const CUtensorMap& tmw, const ConvArgs& args,
                         unsigned blocks, cudaStream_t stream) {
  switch (bn) {
    case 32: return launch_conv<kS8, 32, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    case 64: return launch_conv<kS8, 64, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    case 96: return launch_conv<kS8, 96, SPAN>(tmx, tmw, tmw, args, blocks, stream);
    default: return launch_conv<kS8, 128, SPAN>(tmx, tmw, tmw, args, blocks, stream);
  }
}

template <int SPAN>
cudaError_t launch_f32_bn(int bn, const CUtensorMap& tmx,
                          const CUtensorMap& tmw, const CUtensorMap& tmw_lo,
                          const ConvArgs& args, unsigned blocks,
                          cudaStream_t stream) {
  switch (bn) {
    case 16: return launch_conv<kF32, 16, SPAN>(tmx, tmw, tmw_lo, args, blocks, stream);
    case 32: return launch_conv<kF32, 32, SPAN>(tmx, tmw, tmw_lo, args, blocks, stream);
    case 64: return launch_conv<kF32, 64, SPAN>(tmx, tmw, tmw_lo, args, blocks, stream);
    case 96: return launch_conv<kF32, 96, SPAN>(tmx, tmw, tmw_lo, args, blocks, stream);
    case 128: return launch_conv<kF32, 128, SPAN>(tmx, tmw, tmw_lo, args, blocks, stream);
    default: return launch_conv<kF32, 192, SPAN>(tmx, tmw, tmw_lo, args, blocks, stream);
  }
}

// The arguments and tensor maps of one K3 (elem 2 bytes, bf16), K7 (elem
// 1, int8 mapped as UINT8) or f32 (elem 4) call under plan p.
bool conv_setup(const ConvPlan& p, const void* x, const void* w, int elem,
                int B, int D, int H, int W, int C, int O, CUtensorMap* tmx,
                CUtensorMap* tmw, ConvArgs* a) {
  const CUtensorMapDataType type =
      elem == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t e = elem;
  const uint64_t xd[5] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)D,
                          (uint64_t)B};
  const uint64_t xs[4] = {(uint64_t)C * e, (uint64_t)W * C * e,
                          (uint64_t)H * W * C * e,
                          (uint64_t)D * H * W * C * e};
  const uint32_t boxc = static_cast<uint32_t>(p.span / elem);
  const uint32_t xb[5] = {boxc, (uint32_t)p.tw, (uint32_t)p.th,
                          (uint32_t)p.td, 1};
  const uint64_t wd[2] = {(uint64_t)27 * C, (uint64_t)O};
  const uint64_t ws[1] = {(uint64_t)27 * C * e};
  const uint32_t wb[2] = {boxc, (uint32_t)p.bn};
  if (!hop_host::make_map(tmx, x, 5, xd, xs, xb, p.span, type) ||
      !hop_host::make_map(tmw, w, 2, wd, ws, wb, p.span, type))
    return false;
  a->D = D; a->H = H; a->W = W; a->C = C; a->O = O;
  a->tw = p.tw; a->th = p.th; a->td = p.td;
  a->nx = p.nx; a->ny = p.ny; a->nz = p.nz;
  a->m_tiles = p.m_tiles; a->n_tiles = p.n_tiles;
  a->kc = p.kc;
  a->group = p.group; a->sg = p.sg; a->per_split = p.per_split;
  a->dx_iters = 9 * p.kc;
  a->M = (long long)B * D * H * W;
  return true;
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
  const ConvPlan p = k3_plan(B, D, H, W, C, O, sms);
  if (p.splits != splits) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)p.m_tiles * p.n_tiles * p.splits;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmw;
  ConvArgs a;
  if (!conv_setup(p, x, w, 2, B, D, H, W, C, O, &tmx, &tmw, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  a.bias = static_cast<const float*>(bias);
  a.sw = nullptr;
  a.out = out;
  a.partial = partial;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaError_t e =
      p.span == 128  ? launch_k3_bn<128>(p.bn, tmx, tmw, a, nb, st)
      : p.span == 64 ? launch_k3_bn<64>(p.bn, tmx, tmw, a, nb, st)
                     : launch_k3_bn<32>(p.bn, tmx, tmw, a, nb, st);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long MO = M * O;
  const long long threads = MO / 4;
  conv3x3x3_splitk_reduce<__nv_bfloat16>
      <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), MO, O, splits);
  return static_cast<int>(cudaGetLastError());
}

// One K7 call: `partial` null and splits 1, or int32 [splits, M, O] scratch.
int run_k7(const void* x8, const void* w8, const void* sw, const void* bias,
           void* out, void* partial, int splits, int B, int D, int H, int W,
           int C, int O, int sms, void* stream) {
  const long long M = (long long)B * D * H * W;
  if (M <= 0 || M >= (1LL << 31) || C <= 0 || O <= 0 || C % 32 || O % 32 ||
      sw == nullptr || bias == nullptr ||
      reinterpret_cast<uintptr_t>(x8) % 16 ||
      reinterpret_cast<uintptr_t>(w8) % 16 ||
      (splits > 1) != (partial != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvPlan p = k7_plan(B, D, H, W, C, O, sms);
  if (p.splits != splits) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)p.m_tiles * p.n_tiles * p.splits;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmw;
  ConvArgs a;
  if (!conv_setup(p, x8, w8, 1, B, D, H, W, C, O, &tmx, &tmw, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  a.bias = static_cast<const float*>(bias);
  a.sw = static_cast<const float*>(sw);
  a.out = out;
  a.partial = partial;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaError_t e =
      p.span == 128  ? launch_k7_bn<128>(p.bn, tmx, tmw, a, nb, st)
      : p.span == 64 ? launch_k7_bn<64>(p.bn, tmx, tmw, a, nb, st)
                     : launch_k7_bn<32>(p.bn, tmx, tmw, a, nb, st);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long MO = M * O;
  const long long threads = MO / 4;
  conv3x3x3_int8_splitk_reduce<<<static_cast<unsigned>((threads + 255) / 256),
                                 256, 0, st>>>(
      static_cast<const int*>(partial), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), MO,
      O, p.sg);
  return static_cast<int>(cudaGetLastError());
}

// One f32 conv call: w_pack f32 [2, O, 27*C] (hi, lo); `partial` null and
// splits 1, or f32 [splits, M, O] scratch.
int run_f32(const void* x, const void* w_pack, const void* bias, void* out,
            void* partial, int splits, int B, int D, int H, int W, int C,
            int O, int sms, void* stream) {
  const long long M = (long long)B * D * H * W;
  if (M <= 0 || M >= (1LL << 31) || C <= 0 || O <= 0 || C % 8 || O % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w_pack) % 16 ||
      (splits > 1) != (partial != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvPlan p = kf_plan(B, D, H, W, C, O, sms);
  if (p.splits != splits) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)p.m_tiles * p.n_tiles * p.splits;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmx, tmw, tmw_lo;
  ConvArgs a;
  const float* lo = static_cast<const float*>(w_pack) + (long long)O * 27 * C;
  if (!conv_setup(p, x, w_pack, 4, B, D, H, W, C, O, &tmx, &tmw, &a) ||
      !conv_setup(p, x, lo, 4, B, D, H, W, C, O, &tmx, &tmw_lo, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  a.bias = static_cast<const float*>(bias);
  a.sw = nullptr;
  a.out = out;
  a.partial = partial;
  a.flush = 32 / (p.span / 32);  // iterations of 32 k8 steps
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaError_t e =
      p.span == 128  ? launch_f32_bn<128>(p.bn, tmx, tmw, tmw_lo, a, nb, st)
      : p.span == 64 ? launch_f32_bn<64>(p.bn, tmx, tmw, tmw_lo, a, nb, st)
                     : launch_f32_bn<32>(p.bn, tmx, tmw, tmw_lo, a, nb, st);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long MO = M * O;
  const long long threads = MO / 4;
  conv3x3x3_splitk_reduce<float>
      <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
          static_cast<const float*>(partial),
          static_cast<const float*>(bias), static_cast<float*>(out), MO, O,
          splits);
  return static_cast<int>(cudaGetLastError());
}

// ---- K7's quantize prologue -------------------------------------------------

// max(a, 1e-8) / 127 as the reference computes a scale (clamp_min keeps a
// NaN), from the bits of a non-negative float
__device__ __forceinline__ float int8_scale(unsigned amax_bits) {
  const float a = __uint_as_float(amax_bits);
  return __fdiv_rn(a < 1e-8f ? 1e-8f : a, 127.0f);
}

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  return static_cast<int8_t>(static_cast<int>(rintf(__fdiv_rn(v, scale))));
}

// quantize(f[j], s) for four values, from r = __frcp_rn(s): q1 = f * r,
// corrected by one FMA step, is within about an ulp of f / s, and |f / s|
// <= 127.x here (s is the max over these values / 127), so q1 rounds to
// the integer the IEEE quotient rounds to unless it lies within 2^-10 of a
// half-integer or is not finite; then (about 1 in 500 values) all four take
// quantize's division.
__device__ __forceinline__ void quantize4(const float (&f)[4],
                                          const float (&s)[3],
                                          const float (&r)[3],
                                          int8_t (&q)[4]) {
  bool near = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float q0 = __fmul_rn(f[j], r[j % 3]);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, s[j % 3], f[j]), r[j % 3], q0);
    near |= !(fabsf(q1 - floorf(q1) - 0.5f) > 0x1p-10f);
    q[j] = static_cast<int8_t>(__float2int_rn(q1));
  }
  if (near)
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = quantize(f[j], s[j % 3]);
}

// ---- int8_conv_amax: max |x| per channel, one kernel, no atomics on data --
//
// A block of vs x rpb threads (kernels.amax_plan: vs 16-byte channel
// vectors of one slab of the row, rpb rows at a time, vs * rpb a multiple of
// 32 wherever C allows, so that every lane loads) walks one contiguous range
// of `rows` rows with kAmaxUnroll loads in flight a thread, keeping eight
// running maxima. The grid is one wave (two blocks an SM), so that the
// ranges are equal and no block waits for a second wave. The block's maxima
// meet in shared memory and go out as one partial row [C] a block; then a
// tree of last arrivals reduces them: the last block of each group of
// kAmaxGroup blocks (a counter a group) takes the max of the group's rows,
// and the last of those (a counter a slab) takes the max of the group maxima
// into amax. Each block sends one atomic a level, to its own counter, and
// the counters wrap back to 0 by themselves (atomicInc), so no launch zeroes
// anything; two calls must not run at once on two streams of one card.
constexpr int kAmaxUnroll = 8;
constexpr int kAmaxGroup = 16;       // kernels.AMAX_GROUP
constexpr int kAmaxThreads = 512;    // kernels.AMAX_THREADS
constexpr int kAmaxCounters = 1024;  // kernels.AMAX_COUNTERS
__device__ unsigned int g_amax_count[kAmaxCounters];

__device__ __forceinline__ uint4 umax4(uint4 a, uint4 b) {
  return make_uint4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                    max(a.w, b.w));
}

// dst[c0 .. c0 + width) = the max over n rows of part (the rows first,
// first + step, ..., C words each) of those channels; read from L2, where
// the other blocks' rows are
__device__ __forceinline__ void amax_rows(const unsigned* part,
                                          long long first, int n, int step,
                                          int C, int c0, int width,
                                          unsigned* dst) {
  for (int v = threadIdx.x; v < width / 4; v += blockDim.x) {
    uint4 m = make_uint4(0, 0, 0, 0);
#pragma unroll 4
    for (int i = 0; i < n; ++i)
      m = umax4(m, __ldcg(reinterpret_cast<const uint4*>(
                             part + (first + (long long)i * step) * C + c0) +
                         v));
    reinterpret_cast<uint4*>(dst + c0)[v] = m;
  }
}

// amax (uint32 [C], the bits of f32) = max over the M rows of |x[:, c]|:
// for non-negative floats the unsigned order of the bits is the float
// order, the sign bit is cleared, and a NaN (above inf) wins as in the
// reference's max. part: [gridDim.x, C] scratch.
__global__ void __launch_bounds__(kAmaxThreads, 2)
    int8_conv_amax_kernel(const __nv_bfloat16* __restrict__ x,
                          unsigned* __restrict__ amax,
                          unsigned* __restrict__ part, long long M, int C,
                          int vs, int rpb, long long rows) {
  extern __shared__ uint4 red4[];  // [rpb][vs][2]: eight maxima a thread
  __shared__ bool s_last;
  const int tid = threadIdx.x, lv = tid % vs, rg = tid / vs;
  const int b = blockIdx.x, slab = blockIdx.y, G = gridDim.x;
  const int cv = slab * vs + lv;
  const long long vpr = C / 8;
  const bool active = cv < vpr;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + cv;
  const long long r0 = (long long)b * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  unsigned m[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (long long r = r0 + rg; r < r1; r += (long long)kAmaxUnroll * rpb) {
    uint4 q[kAmaxUnroll];
#pragma unroll
    for (int u = 0; u < kAmaxUnroll; ++u) {
      const long long rr = r + (long long)u * rpb;
      q[u] = active && rr < r1 ? __ldg(xv + rr * vpr) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kAmaxUnroll; ++u) {
      const uint32_t q4[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // bf16 -> f32 bits, sign cleared
        m[2 * i] = max(m[2 * i], (q4[i] << 16) & 0x7fffffffu);
        m[2 * i + 1] = max(m[2 * i + 1], q4[i] & 0x7fff0000u);
      }
    }
  }
  red4[2 * tid] = make_uint4(m[0], m[1], m[2], m[3]);
  red4[2 * tid + 1] = make_uint4(m[4], m[5], m[6], m[7]);
  __syncthreads();
  const unsigned* red = reinterpret_cast<const unsigned*>(red4);
  const int c0 = slab * vs * 8;
  const int width = vs * 8 < C - c0 ? vs * 8 : C - c0;
  for (int j = tid; j < width; j += blockDim.x) {
    unsigned mm = red[j];
    for (int k = 1; k < rpb; ++k) mm = max(mm, red[k * vs * 8 + j]);
    part[(long long)b * C + c0 + j] = mm;
  }
  // the tree of last arrivals
  const int groups = (G + kAmaxGroup - 1) / kAmaxGroup, grp = b / kAmaxGroup;
  const int n1 = G - grp * kAmaxGroup < kAmaxGroup ? G - grp * kAmaxGroup
                                                   : kAmaxGroup;
  unsigned* count = g_amax_count + slab * (groups + 1);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicInc(&count[grp], n1 - 1) == n1 - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long first = (long long)grp * kAmaxGroup;
  amax_rows(part, first, n1, 1, C, c0, width,
            groups == 1 ? amax : part + first * C);
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicInc(&count[groups], groups - 1) == groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  amax_rows(part, 0, groups, kAmaxGroup, C, c0, width, amax);
}

// x8 [M, Cp] = rint(x / sc[c]) for c < C, 0 for the padded channels; eight
// channels (one 16-byte load, one 8-byte store) a thread.
__global__ void __launch_bounds__(256)
    int8_conv_quantize_x_kernel(const __nv_bfloat16* __restrict__ x,
                                const unsigned* __restrict__ amax,
                                int8_t* __restrict__ x8, long long M, int C,
                                int Cp) {
  extern __shared__ float sc[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) sc[c] = int8_scale(amax[c]);
  __syncthreads();
  const int vpr = Cp / 8;
  const long long total = M * vpr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / vpr;
    const int c = static_cast<int>(i % vpr) * 8;
    uint32_t lo = 0, hi = 0;
    if (c < C) {
      const uint4 qv = *reinterpret_cast<const uint4*>(x + r * C + c);
      const uint32_t q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t bits = k % 2 ? q4[k / 2] & 0xffff0000u : q4[k / 2] << 16;
        const uint32_t b = static_cast<uint8_t>(
            quantize(__uint_as_float(bits), sc[c + k]));
        if (k < 4)
          lo |= b << (8 * k);
        else
          hi |= b << (8 * (k - 4));
      }
    }
    *reinterpret_cast<uint2*>(x8 + r * Cp + c) = make_uint2(lo, hi);
  }
}

__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- int8_conv_quantize_w: the weight pass -----------------------------
//
// The weights of output channel o are one contiguous run of 27 * C values
// [C, dz, dy, dx]; the pack wants them dx-major, k = (dx*9 + dz*3 + dy)*Cp
// + c: a transpose of [C, 27] to [27, Cp]. A cluster of ks blocks (at most
// 8) takes one o at a time, each block a slab of cpb channels of it (a
// multiple of 32; ks is larger where the slab would not fit kQwSlabBytes
// or where the output channels are few, so that the card fills). Where
// the clusters of all Op do not fit on the card at once, they are
// persistent, as many as fit, each walking the output channels n_clusters
// apart. A block copies the slab of its o into shared memory with cp.async
// (16-byte pieces where C and the alignment of w allow, all in flight at
// once) and, while it works on it, has the next o's slab brought into L2
// (cp.async.bulk.prefetch.L2), from which the next copy comes: the weights
// are read from device memory once, and the reads overlap the arithmetic.
// Three blocks an SM. A slab is walked twice: first for the three
// per-dx maxima of |wf|, wf = bf16(w) * sc[c] (warp shuffles, the warps,
// then the cluster's blocks through distributed shared memory), writing
// f32 weights over with wf; then to quantize each value into a staging
// [27][kQwStride] bytes, from which each chunk of kQwChunk channels of the
// pack goes out in 16-byte stores. In a chunk a thread takes the four
// elements at (tid + u * kQwThreads) * 4, u = 0, 1, 2: a chunk is 27 * 128
// = 3 * 288 * 4 of them, so the tap t = e % 27 (t = dz*9 + dy*3 + dx) of
// each of a thread's elements is the same in every chunk, and where each
// goes in the staging (row (t%3)*9 + t/3, the pack's tap) and which channel
// scale it takes are worked out once, before the loops; the dx of element
// j is (tid * 4 + j) % 3, so the per-dx maxima and scales sit in registers
// by j % 3. No division in the element loops. Rows o >= O, channels c >= C
// and sw past O are zeros.
constexpr int kQwThreads = 288;
constexpr int kQwChunk = 128;            // 27 * 128 == 3 * 288 * 4
constexpr int kQwStride = kQwChunk + 4;  // a word more: the taps' rows
                                         // start in 27 banks
constexpr int kQwSlabBytes = 50 * 1024;  // a slab's weights, at most

// `bytes` (a multiple of `piece`: 16, 8, 4 or 2) from global to shared
// memory, split over the block's threads: by cp.async from 4-byte pieces
// on (the caller commits and waits), else by plain copies
__device__ __forceinline__ void copy_slab(uint8_t* dst, const uint8_t* src,
                                          int bytes, int piece) {
  const int tid = threadIdx.x;
  if (piece == 16) {
    for (int i = tid * 16; i < bytes; i += kQwThreads * 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       hop::smem_u32(dst + i)),
                   "l"(src + i)
                   : "memory");
  } else if (piece == 8) {
    for (int i = tid * 8; i < bytes; i += kQwThreads * 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       hop::smem_u32(dst + i)),
                   "l"(src + i)
                   : "memory");
  } else if (piece == 4) {
    for (int i = tid * 4; i < bytes; i += kQwThreads * 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       hop::smem_u32(dst + i)),
                   "l"(src + i)
                   : "memory");
  } else {
    for (int i = tid * 2; i < bytes; i += kQwThreads * 2)
      *reinterpret_cast<unsigned short*>(dst + i) =
          *reinterpret_cast<const unsigned short*>(src + i);
  }
}

// four weights from shared memory as the f32 values of their bf16
// roundings
template <typename TW>
__device__ __forceinline__ void smem_vec4(const TW* p, float (&v)[4]) {
  if constexpr (sizeof(TW) == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = bf16_value(r.x), v[1] = bf16_value(r.y);
    v[2] = bf16_value(r.z), v[3] = bf16_value(r.w);
  } else {  // bf16 to f32: the bits in the high half
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the word at `local` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ unsigned cluster_load(const unsigned* local,
                                                 unsigned rank) {
  unsigned addr, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(hop::smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// dynamic shared memory: the slab [27 * cpb] TW, then its scales [cpb] f32
// (three blocks an SM: at most 72 registers a thread)
template <typename TW>
__global__ void __launch_bounds__(kQwThreads, 3)
    int8_conv_quantize_w_kernel(const TW* __restrict__ w,
                                const unsigned* __restrict__ amax,
                                int8_t* __restrict__ w8,
                                float* __restrict__ sw, int C, int O, int Cp,
                                int Op, int cpb, int piece) {
  extern __shared__ __align__(16) uint8_t qw_smem[];
  __shared__ __align__(16) uint8_t stage[27 * kQwStride];
  __shared__ unsigned red[3][kQwThreads / 32];
  __shared__ unsigned s_max[2][3];
  __shared__ float s_sw[3];
  const int ks = static_cast<int>(cluster_size());
  const int kr = static_cast<int>(cluster_rank());
  const int n_clusters = gridDim.x / ks, tid = threadIdx.x;
  const int c_lo = kr * cpb;                           // < C: ks*cpb < Cp+cpb
  const int cw_slab = min(cpb, Cp - c_lo), cn_slab = min(cpb, C - c_lo);
  const int slab_bytes = 27 * cpb * static_cast<int>(sizeof(TW));
  const int copy_bytes = 27 * cn_slab * static_cast<int>(sizeof(TW));
  TW* const slab = reinterpret_cast<TW*>(qw_smem);
  float* sc = reinterpret_cast<float*>(qw_smem + slab_bytes);
  // the cluster's output channels: o0, o0 + n_clusters, ...
  const int o0 = blockIdx.x / ks;
  auto src = [&](int i) {
    return reinterpret_cast<const uint8_t*>(
        w + (long long)(o0 + i * n_clusters) * 27 * C + 27LL * c_lo);
  };
  // the slab of the cluster's i-th o into shared memory, if it is real;
  // and one o further on into L2, so that device memory stays busy
  auto prefetch = [&](int i) {
    if (o0 + i * n_clusters < O)
      copy_slab(reinterpret_cast<uint8_t*>(slab), src(i), copy_bytes, piece);
    hop::cp_async_commit();
    if (tid == 0 && piece == 16 && o0 + (i + 1) * n_clusters < O)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                       src(i + 1)),
                   "r"(copy_bytes)
                   : "memory");
  };
  prefetch(0);
  for (int c = tid; c < cn_slab; c += kQwThreads)
    sc[c] = int8_scale(amax[c_lo + c]);
  // the thread's twelve elements of a chunk: the channel and the staging
  // row of each
  int ch[3][4], srow[3][4];
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int e = (tid + u * kQwThreads) * 4, c = e / 27, t0 = e - 27 * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j < 27 ? t0 + j : t0 + j - 27;
      ch[u][j] = t0 + j < 27 ? c : c + 1;
      srow[u][j] = (t % 3 * 9 + t / 3) * kQwStride;
    }
  }
  const int phase = tid * 4 % 3, lane = tid % 32, warp = tid / 32;
  for (int i = 0; o0 + i * n_clusters < Op; ++i) {
    const int o = o0 + i * n_clusters;
    uint4* row = reinterpret_cast<uint4*>(w8 + (long long)o * 27 * Cp);
    hop::cp_async_wait<0>();    // this o's pieces of this thread
    __syncthreads();            // ... and of every thread; the scales
    if (o >= O) {               // the whole cluster: nothing to share
      const int segs = cw_slab / 16;
      for (int k = tid; k < 27 * segs; k += kQwThreads) {
        const int tp = k / segs;
        row[(tp * Cp + c_lo) / 16 + k - tp * segs] = make_uint4(0, 0, 0, 0);
      }
      if (kr == 0 && tid < 3) sw[tid * Op + o] = 0.f;
      continue;
    }
    TW* const b0 = slab;
    // walk 1: the per-dx maxima, by the element's place j % 3; f32
    // weights are replaced by their folded values wf, which walk 2 reads
    unsigned mj[3] = {0, 0, 0};
    for (int c0 = 0; c0 < cn_slab; c0 += kQwChunk) {
      const int end = 27 * min(kQwChunk, cn_slab - c0);
      TW* b = b0 + 27 * c0;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int e = (tid + u * kQwThreads) * 4;
        if (e >= end) break;
        const int valid = end - e;  // >= 4 but at the run's end
        float v[4];
        smem_vec4<TW>(b + e, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = __fmul_rn(v[j], sc[c0 + ch[u][j]]);
          if (j < valid)
            mj[j % 3] = max(mj[j % 3], __float_as_uint(v[j]) & 0x7fffffffu);
        }
        if constexpr (sizeof(TW) == 4)
          *reinterpret_cast<float4*>(b + e) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    // the maxima of the block, then of the cluster (s_max by the parity
    // of i: a block writes the next one only after every block has arrived
    // past its reads of this one); the scales by slot
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int k = (dx - phase + 3) % 3;  // the slot j % 3 of this dx
      unsigned v = k == 0 ? mj[0] : k == 1 ? mj[1] : mj[2];
      for (int off = 16; off > 0; off /= 2)
        v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) red[dx][warp] = v;
    }
    __syncthreads();
    if (tid < 3) {
      unsigned v = red[tid][0];
      for (int k = 1; k < kQwThreads / 32; ++k) v = max(v, red[tid][k]);
      s_max[i & 1][tid] = v;
    }
    cluster_arrive();
    cluster_wait();
    if (tid < 3) {
      unsigned v = 0;
      for (int r = 0; r < ks; ++r)
        v = max(v, cluster_load(&s_max[i & 1][tid], r));
      s_sw[tid] = int8_scale(v);
      if (kr == 0) sw[tid * Op + o] = s_sw[tid];
    }
    __syncthreads();
    float sk[3], rk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sk[k] = s_sw[(phase + k) % 3];
      rk[k] = __frcp_rn(sk[k]);
    }
    // walk 2: quantize a chunk into the staging, then store it
    for (int c0 = 0; c0 < cw_slab; c0 += kQwChunk) {
      const int cw = min(kQwChunk, cw_slab - c0);  // a multiple of 32
      const int cn = min(cw, cn_slab - c0);        // >= 1
      const int end = 27 * cn;
      if (cn < cw)  // the padded channels stay 0
        for (int k = tid; k < 27 * kQwStride / 4; k += kQwThreads)
          reinterpret_cast<unsigned*>(stage)[k] = 0;
      __syncthreads();
      const TW* b = b0 + 27 * c0;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int e = (tid + u * kQwThreads) * 4;
        if (e >= end) break;
        const int valid = end - e;
        float f[4];
        if constexpr (sizeof(TW) == 4) {  // folded by walk 1
          const float4 r = *reinterpret_cast<const float4*>(b + e);
          f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
        } else {
          smem_vec4<TW>(b + e, f);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            f[j] = __fmul_rn(f[j], sc[c0 + ch[u][j]]);
        }
        int8_t q[4];
        quantize4(f, sk, rk, q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < valid) stage[srow[u][j] + ch[u][j]] = q[j];
      }
      __syncthreads();
      const int segs = cw / 16;
      for (int k = tid; k < 27 * segs; k += kQwThreads) {
        const int tp = k / segs, sg = k - tp * segs;
        const unsigned* p = reinterpret_cast<const unsigned*>(
            stage + tp * kQwStride + 16 * sg);
        row[(tp * Cp + c_lo + c0) / 16 + sg] =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
      __syncthreads();  // the staging and the slab are free
    }
    prefetch(i + 1);  // into the slab buffer, now free; from L2
  }
  cluster_arrive();  // no block leaves while another reads its maxima
  cluster_wait();
}

// the weight pass's grid for one (card, width, dtype): asked of the
// occupancy calculator once and kept, since every call of a serving step
// asks again
struct QwPlan {
  int dev, C, Op, esize, ks, cpb, n_clusters;
};

template <typename TW>
cudaError_t quantize_w_plan(int C, int Cp, int Op, QwPlan* plan) {
  constexpr int kE = sizeof(TW);
  static QwPlan cache[64];
  static int cached = 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < cached; ++i)
    if (cache[i].dev == dev && cache[i].C == C && cache[i].Op == Op &&
        cache[i].esize == kE) {
      *plan = cache[i];
      return cudaSuccess;
    }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // every launch may take as much dynamic shared memory as a block can
  const auto kernel = int8_conv_quantize_w_kernel<TW>;
  int optin = 0;
  cudaFuncAttributes fa;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (e != cudaSuccess) return e;
  auto smem = [&](int cpb) { return 27 * cpb * kE + 4 * cpb; };
  auto per_sm = [&](int bytes) {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, kernel, kQwThreads, bytes) == cudaSuccess ? n : 0;
  };
  // the slab: as wide as kQwSlabBytes allows, at most 8 blocks an output
  // channel (wider slabs past 8 * kQwSlabBytes)
  const int lanes = Cp / 32;
  auto split = [&](int ks, int& cpb) {
    if (ks > 8) ks = 8;
    if (ks > lanes) ks = lanes;
    cpb = (lanes + ks - 1) / ks * 32;
    return (Cp + cpb - 1) / cpb;
  };
  int cpb = kQwSlabBytes / (27 * kE) / 32 * 32;
  int ks = split((Cp + cpb - 1) / cpb, cpb);
  // one wave where every o's cluster fits on the card at once, its slabs
  // narrowed while more blocks fit; else as many persistent clusters as
  // fit, walking the o's n_clusters apart
  int n_clusters = Op;
  const int cap = sms * per_sm(smem(cpb));
  if (Op * ks <= cap) {
    if (cap / Op > ks) ks = split(cap / Op, cpb);
  } else {
    n_clusters = cap / ks;
  }
  if (n_clusters < 1) return cudaErrorInvalidValue;
  *plan = QwPlan{dev, C, Op, kE, ks, cpb, n_clusters};
  if (cached < 64) cache[cached++] = *plan;
  return cudaSuccess;
}

template <typename TW>
cudaError_t launch_quantize_w(const TW* w, const unsigned* amax, int8_t* w8,
                              float* sw, int C, int O, int Cp, int Op,
                              cudaStream_t st) {
  constexpr int kE = sizeof(TW);
  QwPlan p;
  const cudaError_t e = quantize_w_plan<TW>(C, Cp, Op, &p);
  if (e != cudaSuccess) return e;
  // pieces of the slab copy: 16 bytes where every row's slab starts on 16
  const int row_bytes = 27 * C * kE;
  int piece = 16;
  while (piece > kE &&
         (row_bytes % piece || reinterpret_cast<uintptr_t>(w) % piece))
    piece /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.n_clusters * p.ks));
  cfg.blockDim = dim3(kQwThreads);
  cfg.dynamicSmemBytes = 27 * p.cpb * kE + 4 * p.cpb;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_conv_quantize_w_kernel<TW>, w, amax,
                            w8, sw, C, O, Cp, Op, p.cpb, piece);
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

// The number of K slices the f32 conv takes on a card with `sms` SMs.
int conv3x3x3_f32_splits(int B, int D, int H, int W, int C, int O, int sms) {
  return kf_plan(B, D, H, W, C, O, sms).splits;
}

// The f32 conv (3xTF32 on the tensor cores): x f32 [B, D, H, W, C], w_pack
// f32 [2, O, 27*C] (the tf32 hi and lo of the packed weights), bias f32 [O]
// or null (the input gradient), out f32 [B, D, H, W, O]; C and O multiples
// of 8; `partial` and `splits` as conv3x3x3_bf16 takes them.
int conv3x3x3_f32(const void* x, const void* w_pack, const void* bias,
                  void* out, void* partial, int splits, int B, int D, int H,
                  int W, int C, int O, int sms, void* stream) {
  return run_f32(x, w_pack, bias, out, partial, splits, B, D, H, W, C, O,
                 sms, stream);
}

// The number of K slices K7 takes on a card with `sms` SMs (1, or a
// multiple of 3: the same number in each dx group).
int conv3x3x3_int8_splits(int B, int D, int H, int W, int C, int O, int sms) {
  return k7_plan(B, D, H, W, C, O, sms).splits;
}

// K7: x8 int8 [B, D, H, W, C], w8 the dx-major int8 pack [O, 27*C], sw f32
// [3, O], bias f32 [O], out bf16 [B, D, H, W, O]; `partial` null with one
// slice, else int32 [splits, B*D*H*W, O] scratch and the exact reduce
// follows.
int conv3x3x3_int8(const void* x8, const void* w8, const void* sw,
                   const void* bias, void* out, void* partial, int splits,
                   int B, int D, int H, int W, int C, int O, int sms,
                   void* stream) {
  return run_k7(x8, w8, sw, bias, out, partial, splits, B, D, H, W, C, O,
                sms, stream);
}

// amax (uint32 [C], the bits of f32) = max |x| per channel of bf16 x
// [M, C], C a multiple of 8, through part (uint32 [blocks, C] scratch) on
// the plan of kernels.amax_plan: `slabs` slabs of vs channel vectors, blocks
// of vs x rpb threads, each over `rows` rows.
int int8_conv_amax(const void* x, void* amax, void* part, long long M, int C,
                   int vs, int rpb, int slabs, int blocks, long long rows,
                   void* stream) {
  const long long vpr = C / 8;
  const int groups = (blocks + kAmaxGroup - 1) / kAmaxGroup;
  if (M <= 0 || C <= 0 || C % 8 || vs <= 0 || rpb <= 0 || slabs <= 0 ||
      blocks <= 0 || rows <= 0 || vs * rpb > kAmaxThreads ||
      (long long)slabs * vs < vpr || (long long)(slabs - 1) * vs >= vpr ||
      blocks * rows < M || (long long)(blocks - 1) * rows >= M ||
      (long long)slabs * (groups + 1) > kAmaxCounters ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(amax) % 16 ||
      reinterpret_cast<uintptr_t>(part) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_conv_amax_kernel<<<dim3(blocks, slabs), vs * rpb,
                          sizeof(uint4) * 2 * vs * rpb,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<unsigned*>(amax),
      static_cast<unsigned*>(part), M, C, vs, rpb, rows);
  return static_cast<int>(cudaGetLastError());
}

// x8 int8 [M, Cp] from bf16 x [M, C] and int8_conv_amax's amax; C a
// multiple of 8, Cp >= C a multiple of 32.
int int8_conv_quantize_x(const void* x, const void* amax, void* x8,
                         long long M, int C, int Cp, void* stream) {
  if (M <= 0 || C <= 0 || C % 8 || Cp % 32 || Cp < C || C > 12288 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(x8) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = M * (Cp / 8);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  int8_conv_quantize_x_kernel<<<static_cast<unsigned>(blocks), 256,
                                sizeof(float) * C,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const unsigned*>(amax), static_cast<int8_t*>(x8), M, C, Cp);
  return static_cast<int>(cudaGetLastError());
}

// w8 int8 [Op, 27*Cp] (dx-major) and sw f32 [3, Op] from the weights w
// [O, C, 3, 3, 3] (f32, rounded to bf16 first, or bf16 when w_bf16) and
// int8_conv_amax's amax; Cp >= C and Op >= O multiples of 32, w aligned to
// its element, w8 to 16 bytes.
int int8_conv_quantize_w(const void* w, int w_bf16, const void* amax,
                         void* w8, void* sw, int C, int O, int Cp, int Op,
                         void* stream) {
  if (C <= 0 || O <= 0 || Cp % 32 || Op % 32 || Cp < C || Op < O ||
      C > 12288 || reinterpret_cast<uintptr_t>(w) % (w_bf16 ? 2 : 4) ||
      reinterpret_cast<uintptr_t>(w8) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* am = static_cast<const unsigned*>(amax);
  int8_t* q = static_cast<int8_t*>(w8);
  float* s = static_cast<float*>(sw);
  const cudaError_t e =
      w_bf16 ? launch_quantize_w(static_cast<const __nv_bfloat16*>(w), am, q,
                                 s, C, O, Cp, Op, st)
             : launch_quantize_w(static_cast<const float*>(w), am, q, s, C,
                                 O, Cp, Op, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
