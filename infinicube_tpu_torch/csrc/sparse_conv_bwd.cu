// Weight gradient of the sparse submanifold 3x3x3 convolution on voxel rows
// for Hopper (sm_90a), f32 in and out, behind a plain C interface (loaded
// with ctypes by infinicube_tpu_torch/kernels).
//
// sparse_conv_f32_wgrad (K6) replaces the TPU kernel
//   infinicube_tpu/ops/window_conv.py:252 `_dw_core` (reached from `_wc_bwd`,
//   the backward of `window_sparse_conv`), which runs once per SparseConv3d
//   and train step of the sparse VAE: 24 per step at (F, Fo) from (32, 64) to
//   (256, 256) on 32,768 .. 131,072 voxel rows per batch element.
//   dw[t, f, o] = sum_{b, m} feats[b, nbr[b, m, t], f] * g[b, m, o]
//   over the rows whose tap-t neighbour is present (nbr >= 0); padding rows
//   (all taps -1) and absent taps contribute nothing.
// (The input gradient of the same conv is sparse_conv_f32 of sparse_conv.cu on
// the output gradient with the reversed, transposed weights.)
//
// What bounds it: 2 * F * Fo operations per present (row, tap) pair against
// (F + Fo) * 4 bytes per row, far above the ridge, so operations. The first
// version ran them as f32 FFMA on the CUDA cores (67 TFLOP/s on an H100 SXM)
// at 15-27 % of that bound. This one takes them to the tensor cores by the
// 3xTF32 split, as K4 does: each operand a becomes hi = tf32(a) and lo =
// tf32(a - hi), and a product is lo_A hi_B + hi_A lo_B + hi_A hi_B on wgmma
// m64nNk8 .f32.tf32.tf32 (495 TFLOP/s: 165 TFLOP/s of f32 work).
//
// Design. Per tap the product is [F x rows] . [rows x Fo]: M = F, N = Fo and
// the reduction runs over the B * C voxel rows. tf32 wgmma has no transpose
// bit, so an operand in shared memory must be K-major (voxel rows
// contiguous), and neither operand arrives that way:
// - A = the gathered feats rows, from registers. A producer warpgroup
//   gathers each stage's 32 neighbour rows (the F tile's features) with
//   cp.async, src-size 0 for an absent tap, into a row-major staging buffer
//   whose pitch is F tile + 8 floats, so that the 32 lanes of a warp reading
//   one A fragment (8 features x 4 rows) hit 32 banks. The consumers load
//   their m64k8 A fragments from it and split them into hi and lo in
//   registers.
// - B = g^T, written once a call by a prologue kernel (sparse_wgrad_pack)
//   as its tf32 hi and lo parts, f32 [2, Fo, rows]; g does not depend on the
//   tap, so one pack serves all 27. Two 2-D TMA boxes a stage (32 rows: the
//   128-byte swizzle span, by the N tile) feed the B operand.
// - The tensor cores truncate every sum they accumulate, and a dw element
//   sums up to 10^5 rows: the wgmma sums are added into f32 sums with a
//   rounded add every 32 k8 steps and restarted (scale-d 0), as the f32
//   conv does. Both sums live in registers; the producer hands its
//   registers to the consumers (setmaxnreg).
// - A block owns (tap, F tile, N tile, row range). The ranges are a function
//   of the shape only (rows_per_split from the wrapper); the block first
//   lists the 32-row chunks of its range in which some row has the tap's
//   neighbour and walks only those, in order. An F tile of 128 gives each
//   consumer warpgroup 64 features of every stage; an F tile of 64 (F <= 64)
//   gives both the same features and half of each stage's rows, and the
//   second adds its sums into the first's through shared memory at the end.
//   Each block writes its tile of partial[s] (or of dw, where one range
//   covers the rows); a second kernel sums the partials in the order
//   s = 0 .. S-1. No atomics: the result is bit-identical from run to run.
//
// sparse_conv_bf16_wgrad replaces the same `_dw_core` on bf16 operands (the
// GSM's voxel branch in gsm_bf16_config): bf16 feats and output gradient,
// every product added into f32 sums, dw f32 (the wrapper rounds it to the
// weight's bf16 as window_conv.py:342 does). bf16 wgmma has a transpose bit
// for both operands, so neither needs a prologue:
// - A = the gathered feats rows, M (features) contiguous: the producer
//   warpgroup gathers each stage's 64 neighbour rows with cp.async into
//   panels of 64 rows x 64 features in the 128-byte-swizzled layout that a
//   TMA box of the same shape would write, read MN-major;
// - B = the output gradient's 64 rows as they lie in memory, N contiguous:
//   one 2-D TMA box per 64 output features, read MN-major;
// - a thread signals a stage only after its copies have landed and a proxy
//   fence (wgmma reads through the async proxy), two stages in flight;
// - sums flushed into f32 sums every 32 k16 steps, the blocks, row ranges
//   and the ordered sum of partials as in the f32 kernel, so the result is
//   bit-identical from run to run.
// Both are one kernel template over the element type (Tf32x3, Bf16 below):
// the chunk list, ring, flushes, the F-tile-64 merge and the store are
// shared; the operands' loads and the products are the type's own.
// The entry points return cudaGetLastError() (or cudaErrorInvalidValue for
// what they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTaps = 27;
constexpr int kThreads = 384;   // warpgroups 0, 1 consume, 2 gathers
constexpr int kRing = 204800;   // bytes of shared memory for the ring
constexpr int kFlushSteps = 32;  // k steps between flushes of the sums
constexpr int kPanel = 64 * 128;  // bf16: 64 rows x 64 features, swizzled
// registers a thread after the hand-over: the producer keeps 40, each
// consumer takes 232 (2 x 128 x 232 + 128 x 40 = 384 x 168, the pool of a
// block launched with 168 a thread)
constexpr int kProducerRegs = 40, kConsumerRegs = 232, kLaunchRegs = 168;

// The element types. Each range of rows is walked in chunks of kRows, one
// stage each, and holds at most kMaxChunks of them (16,384 rows).
struct Tf32x3 {  // f32 operands as tf32 hi and lo
  using E = float;
  static constexpr int kParts = 2;  // the B boxes (hi, lo) a stage
  static constexpr int kRows = 32;  // one 128-byte span of g^T's pack
  static constexpr int kMaxChunks = 512;
  static constexpr int kLag = 0;    // stages signalled by cp.async itself
};

struct Bf16 {  // bf16 operands, both MN-major
  using E = __nv_bfloat16;
  static constexpr int kParts = 1;
  static constexpr int kRows = 64;  // four k16 steps
  static constexpr int kMaxChunks = 256;
  static constexpr int kLag = 2;    // stages a producer thread keeps in flight
};

// FT features (A, M) and BN output features (B, N) a block. A stage holds
// in f32 the B boxes' hi and lo (BN x 32 rows each) and then the gathered
// rows, FT + 8 floats a row; in bf16 the gathered rows' FT / 64 panels and
// then B's BN / 64.
template <class Op, int FT, int BN>
struct K6Tile {
  static constexpr bool kF32 = Op::kParts == 2;
  static constexpr int kPitch = FT + 8;  // floats a staged f32 row
  static constexpr int kA =
      kF32 ? Op::kRows * kPitch * 4 : (FT / 64) * kPanel;
  static constexpr int kB = kF32 ? BN * 128 : (BN / 64) * kPanel;
  static constexpr int kAOff = kF32 ? 2 * kB : 0;
  static constexpr int kBOff = kF32 ? 0 : kA;
  static constexpr int kStage = kA + Op::kParts * kB;
  static constexpr int kStages = kRing / kStage > 8 ? 8 : kRing / kStage;
  // k steps of a stage each consumer warpgroup takes
  static constexpr int kSteps = FT == 128 ? 4 : 2;
  // ring, barriers, chunk list and its count, room to align to 1 KB
  static constexpr int kSmem =
      kStages * kStage + 2 * 8 * kStages + 4 * (Op::kMaxChunks + 1) + 1024;
  static_assert(kStage % 1024 == 0, "B boxes need 1 KB alignment");
  static_assert(kStages >= Op::kLag + 1, "the producer's lag needs the ring");
};

template <typename E>
struct K6Args {
  const E* feats;      // [B, C, F]
  const int* nbr;      // int32 [B, C, 27]
  float* out;          // f32 [S, 27, F, Fo] partials, or dw where S == 1
  long long rows;      // B * C
  int C, F, Fo;
  int rows_per_split;  // a multiple of kRows, at most kRows * kMaxChunks
  int f_tiles, n_tiles;
};

__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

template <class Op, int FT, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_wgrad_kernel(const __grid_constant__ CUtensorMap tmg,
                        const K6Args<typename Op::E> a) {
  using T = K6Tile<Op, FT, BN>;
  using E = typename Op::E;
  constexpr int kR = Op::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStage);
  uint64_t* empty = full + T::kStages;
  int* sList = reinterpret_cast<int*>(empty + T::kStages);
  int* sCount = sList + Op::kMaxChunks;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int bid = blockIdx.x;
  const int t = bid % kTaps;
  bid /= kTaps;
  const int ft = bid % a.f_tiles;
  bid /= a.f_tiles;
  const int nt = bid % a.n_tiles;
  const int s = bid / a.n_tiles;
  const int f0 = ft * FT, n0 = nt * BN;
  const long long r_begin = (long long)s * a.rows_per_split;
  const long long r_end = min(a.rows, r_begin + a.rows_per_split);
  const int n_chunks = static_cast<int>((r_end - r_begin + kR - 1) / kR);

  if (tid == 0) {
    for (int i = 0; i < T::kStages; ++i) {
      hop::mbar_init(&full[i], 128 + 1);  // 128 gathers, the B boxes' tx
      hop::mbar_init(&empty[i], 8);       // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  // the chunks of the range in which some row has the tap's neighbour: a
  // flag each, then compacted in order by warp 0 (in place: a group's flags
  // are read before any index of it is written, and indices never pass
  // their flag)
  for (int c = warp; c < n_chunks; c += kThreads / 32) {
    bool any = false;
#pragma unroll
    for (int h = 0; h < kR / 32; ++h) {
      const long long row = r_begin + (long long)c * kR + 32 * h + lane;
      const int src = row < r_end ? a.nbr[row * kTaps + t] : -1;
      any |= __ballot_sync(0xffffffffu, src >= 0) != 0u;
    }
    if (lane == 0) sList[c] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const int c = c0 + lane;
      const bool f = c < n_chunks && sList[c] != 0;
      const unsigned bits = __ballot_sync(0xffffffffu, f);
      if (f) sList[n + __popc(bits & ((1u << lane) - 1u))] = c;
      n += __popc(bits);
    }
    if (lane == 0) *sCount = n;
  }
  __syncthreads();
  const int count = *sCount;

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: 128 / kR threads a row, thread 0 the B boxes ----
    hop::setmaxnreg_dec<kProducerRegs>();
    constexpr int kPerRow = 128 / kR;
    const int p = tid - 256, prow = p / kPerRow, part = p % kPerRow;
    if (p == 0) hop::prefetch_map(&tmg);
    int stage = 0, signal = 0;
    uint32_t phase = 0;
    for (int it = 0; it < count; ++it) {
      hop::mbar_wait(&empty[stage], phase ^ 1);
      const long long r0 = r_begin + (long long)sList[it] * kR;
      uint8_t* st = ring + stage * T::kStage;
      uint8_t* sb = st + T::kBOff;
      if (p == 0) {
        hop::mbar_expect_tx(&full[stage], Op::kParts * T::kB);
        if constexpr (T::kF32) {  // g^T's hi and lo: [2, Fo, rows]
          hop::tma_load_3d(sb, &tmg, &full[stage], static_cast<int>(r0), n0,
                           0);
          hop::tma_load_3d(sb + T::kB, &tmg, &full[stage],
                           static_cast<int>(r0), n0, 1);
        } else {  // g's rows as they lie, 64 output features a box
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hop::tma_load_2d(sb + j * kPanel, &tmg, &full[stage], n0 + 64 * j,
                             static_cast<int>(r0));
        }
      }
      const long long row = r0 + prow;
      const int src = row < r_end ? a.nbr[row * kTaps + t] : -1;
      const E* frow =
          a.feats + ((row / a.C) * a.C + (src >= 0 ? src : 0)) * a.F + f0;
      if constexpr (T::kF32) {
        // row-major staging, a quarter of the row's 16-byte chunks each
        float* dst = reinterpret_cast<float*>(st + T::kAOff) + prow * T::kPitch;
#pragma unroll
        for (int j = 0; j < FT / 16; ++j) {
          const int c = (4 * j + part) * 4;
          const bool ok = src >= 0 && f0 + c < a.F;
          hop::cp_async16(dst + c, ok ? frow + c : a.feats, ok);
        }
        hop::cp_async_arrive(&full[stage]);
      } else {
        // FT = 128: this thread's panel (64 features); FT = 64: half the row
        constexpr int kPer = FT == 128 ? 8 : 4;
        uint8_t* panel =
            st + T::kAOff + (FT == 128 ? part * kPanel : 0) + prow * 128;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int c = FT == 128 ? i : part * 4 + i;         // 16-byte chunk
          const int f = (FT == 128 ? 64 * part : 0) + 8 * c;  // its feature
          const bool ok = src >= 0 && f0 + f < a.F;
          hop::cp_async16(panel + ((c ^ (prow % 8)) * 16),
                          ok ? frow + f : a.feats, ok);
        }
        hop::cp_async_commit();
        if (it >= Op::kLag) {  // stage it - kLag has landed: hand it over
          hop::cp_async_wait<Op::kLag>();
          hop::fence_proxy_async();
          hop::mbar_arrive(&full[signal]);
          if (++signal == T::kStages) signal = 0;
        }
      }
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (Op::kLag > 0) {
      hop::cp_async_wait<0>();
      hop::fence_proxy_async();
      for (int it = count > Op::kLag ? count - Op::kLag : 0; it < count;
           ++it) {
        hop::mbar_arrive(&full[signal]);
        if (++signal == T::kStages) signal = 0;
      }
    }
  } else {
    // ---- consumers: 64 features each, all BN output features ----
    hop::setmaxnreg_inc<kConsumerRegs>();
    constexpr int kS = T::kSteps;
    constexpr int kFlush = kFlushSteps / kS;  // stages between flushes
    const int wt = tid % 128, w = wt / 32, g = lane / 4, q = lane % 4;
    // this thread's A rows (features) and its warpgroup's first k step
    const int fa = (FT == 128 ? 64 * wg : 0) + 16 * w + g;
    const int k0 = FT == 128 ? 0 : kS * wg;
    float acc[BN / 2], sum[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
    int stage = 0, since = 0;
    uint32_t phase = 0;
    for (int it = 0; it < count; ++it) {
      hop::mbar_wait(&full[stage], phase);
      const uint8_t* st = ring + stage * T::kStage;
      const uint8_t* sb = st + T::kBOff;
      if constexpr (T::kF32) {
        const float* sa = reinterpret_cast<const float*>(st + T::kAOff);
        // the m64k8 A fragments of this warpgroup's k8 steps, split into
        // tf32 hi and lo: a[0] (feature fa, row k), a[1] (fa + 8, k), a[2]
        // and a[3] the same features at row k + 4, k = 8 * step + q
        uint32_t ah[kS][4], al[kS][4];
#pragma unroll
        for (int kk = 0; kk < kS; ++kk) {
          const float* r = sa + (8 * (k0 + kk) + q) * T::kPitch + fa;
          const float v[4] = {r[0], r[8], r[4 * T::kPitch],
                              r[4 * T::kPitch + 8]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hi = tf32_trunc(v[i]);
            ah[kk][i] = __float_as_uint(hi);
            al[kk][i] = __float_as_uint(tf32_trunc(v[i] - hi));
          }
        }
        hop::fence_regs(acc);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kS; ++kk) {  // a k8 step is 32 bytes of B rows
          const uint64_t dh =
              hop::make_desc(sb + 32 * (k0 + kk), 128, 16, 1024);
          const uint64_t dl =
              hop::make_desc(sb + T::kB + 32 * (k0 + kk), 128, 16, 1024);
          // the small terms first; the first product after a flush restarts
          hop::WgmmaTf32<BN>::rs(acc, al[kk], dh,
                                 since == 0 && kk == 0 ? 0 : 1);
          hop::WgmmaTf32<BN>::rs(acc, ah[kk], dl, 1);
          hop::WgmmaTf32<BN>::rs(acc, ah[kk], dh, 1);
        }
      } else {
        const uint8_t* sa = st + T::kAOff + (FT == 128 ? wg * kPanel : 0);
        hop::fence_regs(acc);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kS; ++kk) {  // a k16 step is 16 rows, 2 KB
          const int off = (k0 + kk) * 2048;
          hop::WgmmaT<BN>::ss(acc, hop::make_desc(sa + off, 128, kPanel, 1024),
                              hop::make_desc(sb + off, 128, kPanel, 1024),
                              since == 0 && kk == 0 ? 0 : 1);
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (lane == 0) hop::mbar_arrive(&empty[stage]);
      if (++since == kFlush || it == count - 1) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
        since = 0;
      }
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (FT == 64) {
      // both warpgroups hold the same features: the second's sums go to the
      // first through the (now idle) ring and are added in that order
      float* xfer = reinterpret_cast<float*>(ring);
      hop::named_barrier(1, 256);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) xfer[i * 128 + wt] = sum[i];
      }
      hop::named_barrier(1, 256);
      if (wg == 1) return;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sum[i] = __fadd_rn(sum[i], xfer[i * 128 + wt]);
    }
    float* out = a.out + ((long long)s * kTaps + t) * a.F * a.Fo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + fa + 8 * h;
      if (f >= a.F) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n < a.Fo)
          *reinterpret_cast<float2*>(out + (long long)f * a.Fo + n) =
              make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
      }
    }
  }
}

// g [rows, Fo] -> pack [2, Fo, ld]: the tf32 hi and lo of g^T (columns
// rows .. ld-1 zero), through a 32 x 32 tile in shared memory.
__global__ void __launch_bounds__(256)
    sparse_wgrad_pack_kernel(const float* __restrict__ g,
                             float* __restrict__ pack, long long rows, int Fo,
                             long long ld) {
  __shared__ float tile[32][33];
  const long long r0 = (long long)blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const long long r = r0 + i;
    const int c = c0 + threadIdx.x;
    tile[i][threadIdx.x] = r < rows && c < Fo ? g[r * Fo + c] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i;
    const long long r = r0 + threadIdx.x;
    if (c < Fo && r < ld) {
      const float v = tile[threadIdx.x][i];
      const float hi = tf32_trunc(v);
      pack[(long long)c * ld + r] = hi;
      pack[((long long)Fo + c) * ld + r] = tf32_trunc(v - hi);  // exact
    }
  }
}

// dw[i] = partial[0][i] + partial[1][i] + ... in that order, 4 values a thread
__global__ void __launch_bounds__(256)
    sparse_wgrad_reduce_kernel(const float* __restrict__ partial,
                               float* __restrict__ dw, long long n4, int S) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4* p = reinterpret_cast<const float4*>(partial);
  float4 sum = p[i];
  for (int s = 1; s < S; ++s) {
    const float4 v = p[(long long)s * n4 + i];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  reinterpret_cast<float4*>(dw)[i] = sum;
}

template <class Op, int FT, int BN>
cudaError_t launch_tile(unsigned blocks, cudaStream_t stream,
                        const CUtensorMap& tmg,
                        const K6Args<typename Op::E>& a) {
  return hop_host::launch_handover<&sparse_wgrad_kernel<Op, FT, BN>>(
      K6Tile<Op, FT, BN>::kSmem, blocks, kThreads, kLaunchRegs, stream, tmg,
      a);
}

// The entry points' common body: the checks, the tiles, g's map (made by
// map_g(&map, rows, bn), which may launch a prologue first), the kernel at
// F's and Fo's tiles and, where there is more than one range, the ordered
// sum of the partials.
template <class Op, class MapG>
int launch_k6(const void* feats, const void* nbr, void* partial, void* dw,
              int B, int C, int F, int Fo, int rows_per_split,
              cudaStream_t st, MapG map_g) {
  using E = typename Op::E;
  constexpr int kPiece = 16 / sizeof(E);
  if (B <= 0 || C <= 0 || F <= 0 || Fo <= 0 || F % kPiece || Fo % kPiece ||
      rows_per_split <= 0 || rows_per_split % Op::kRows ||
      rows_per_split > Op::kRows * Op::kMaxChunks ||
      reinterpret_cast<uintptr_t>(feats) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * C;
  const long long S = (rows + rows_per_split - 1) / rows_per_split;
  if (rows >= (1LL << 31) || (S > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ft = F <= 64 ? 64 : 128, bn = Fo <= 64 ? 64 : 128;
  K6Args<E> a;
  a.feats = static_cast<const E*>(feats);
  a.nbr = static_cast<const int*>(nbr);
  a.out = static_cast<float*>(S == 1 ? dw : partial);
  a.rows = rows;
  a.C = C;
  a.F = F;
  a.Fo = Fo;
  a.rows_per_split = rows_per_split;
  a.f_tiles = (F + ft - 1) / ft;
  a.n_tiles = (Fo + bn - 1) / bn;
  const long long blocks = S * kTaps * a.f_tiles * a.n_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmg;
  cudaError_t e = map_g(&tmg, rows, bn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned nb = static_cast<unsigned>(blocks);
  e = ft == 64 ? (bn == 64 ? launch_tile<Op, 64, 64>(nb, st, tmg, a)
                           : launch_tile<Op, 64, 128>(nb, st, tmg, a))
               : (bn == 64 ? launch_tile<Op, 128, 64>(nb, st, tmg, a)
                           : launch_tile<Op, 128, 128>(nb, st, tmg, a));
  if (e != cudaSuccess || S == 1) return static_cast<int>(e);
  const long long n4 = (long long)kTaps * F * Fo / 4;
  sparse_wgrad_reduce_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256,
                               0, st>>>(static_cast<const float*>(partial),
                                        static_cast<float*>(dw), n4,
                                        static_cast<int>(S));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// feats [B, C, F], nbr int32 [B, C, 27], g [B, C, Fo] -> dw [27, F, Fo];
// pack is scratch of 2 * Fo * ld floats (ld = B * C rounded up to 4),
// partial of [S, 27, F, Fo] floats with S = ceil(B * C / rows_per_split)
// (unused, and may be null, where S == 1); rows_per_split is a multiple of
// 32 and at most 16,384.
int sparse_conv_f32_wgrad(const void* feats, const void* nbr, const void* g,
                          void* pack, void* partial, void* dw, int B, int C,
                          int F, int Fo, int rows_per_split, void* stream) {
  if (reinterpret_cast<uintptr_t>(pack) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto map_g = [&](CUtensorMap* tmg, long long rows, int bn) {
    const long long ld = (rows + 3) / 4 * 4;
    sparse_wgrad_pack_kernel<<<dim3(static_cast<unsigned>((ld + 31) / 32),
                                    static_cast<unsigned>((Fo + 31) / 32)),
                               dim3(32, 8), 0, st>>>(
        static_cast<const float*>(g), static_cast<float*>(pack), rows, Fo,
        ld);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const uint64_t dims[3] = {(uint64_t)ld, (uint64_t)Fo, 2};
    const uint64_t strides[2] = {(uint64_t)ld * 4, (uint64_t)ld * Fo * 4};
    const uint32_t box[3] = {(uint32_t)Tf32x3::kRows, (uint32_t)bn, 1};
    return hop_host::make_map(tmg, pack, 3, dims, strides, box, 128,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
               ? cudaSuccess
               : cudaErrorInvalidValue;
  };
  return launch_k6<Tf32x3>(feats, nbr, partial, dw, B, C, F, Fo,
                           rows_per_split, st, map_g);
}

// feats bf16 [B, C, F], nbr int32 [B, C, 27], g bf16 [B, C, Fo] -> dw f32
// [27, F, Fo]; partial is scratch of [S, 27, F, Fo] floats with S =
// ceil(B * C / rows_per_split) (unused, and may be null, where S == 1);
// F and Fo multiples of 8; rows_per_split a multiple of 64, at most 16,384.
int sparse_conv_bf16_wgrad(const void* feats, const void* nbr, const void* g,
                           void* partial, void* dw, int B, int C, int F,
                           int Fo, int rows_per_split, void* stream) {
  if (reinterpret_cast<uintptr_t>(g) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto map_g = [&](CUtensorMap* tmg, long long rows, int) {
    const uint64_t dims[2] = {(uint64_t)Fo, (uint64_t)rows};
    const uint64_t strides[1] = {(uint64_t)Fo * 2};
    const uint32_t box[2] = {64, (uint32_t)Bf16::kRows};
    return hop_host::make_map(tmg, g, 2, dims, strides, box, 128,
                              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
               ? cudaSuccess
               : cudaErrorInvalidValue;
  };
  return launch_k6<Bf16>(feats, nbr, partial, dw, B, C, F, Fo,
                         rows_per_split, static_cast<cudaStream_t>(stream),
                         map_g);
}

}  // extern "C"
