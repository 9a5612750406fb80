// Weight gradient of the sparse submanifold 3x3x3 convolution on voxel rows
// for Hopper (sm_90a), behind a plain C interface (loaded with ctypes by
// infinicube_tpu_torch/kernels).
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
// GSM's voxel branch in gsm_bf16_config: ten convs a train step at seven
// (F, Fo) shapes from 64 -> 64 to 384 -> 128 on 65,536-slot levels of which
// 3,712 .. 65,536 rows are voxels): bf16 feats and output gradient, every
// product added into f32 sums, dw f32 (the wrapper rounds it to the weight's
// bf16 as window_conv.py:342 does). Bound by operations (2 * F * Fo per
// present pair at 989 TFLOP/s) against a few MB; what holds it back is
// gathering the operands' rows from L2, since each row is gathered again for
// each of its up to 27 neighbours (and each tile). Measured on an NVIDIA
// H100 80GB HBM3 at its 700 W limit, cp.async row gathers move about 25-34
// KB/us an SM whatever the ring depth (a warp's copy of 4 rows of 128 bytes
// at a time), one-row TMA boxes about 10 KB/us, and the two together no
// more than cp.async alone; so the design
// gathers every operand row once a present pair and tile, in long stages,
// with two producer warpgroups. One call = three kernels:
// - wgrad_pairs (the neighbour table read once, coalesced): blocks over
//   fixed segments of rows compact, per tap, the (row, neighbour row) pairs
//   whose tap is present, in row order, into the segment's slice of the
//   tap's list, and write the segment's count;
// - wgrad_bf16 (the products): a stage is 128 consecutive pairs of one tap
//   (stages of 64 ran 14-20 % slower at the widest tile on that card); a
//   unit is (F tile, N tile, tap), the stages of its pairs; the stages of
//   all units, in that order, are cut into equal ranges (at most
//   `ranges`, a constant of the wrapper), so every range holds the same
//   number of stages and the cuts depend on the per-tap counts and the
//   shape alone. Persistent blocks, one an SM, each walk their ranges
//   (block b: b, b + grid, ...); no block exists for padding slots, and no
//   stage holds an absent tap. Each block first reads the segments' counts
//   and takes their prefix per tap. The first producer warpgroup copies the
//   stages' pairs, 1,024 at a time, into shared memory with cp.async, a
//   batch ahead (a cursor over the segments finds each pair's place); then
//   both producer warpgroups gather each stage's feats rows (A, the F
//   tile's features) and output-gradient rows (B, the N tile's) with
//   cp.async, 8 lanes a 128-byte row, into panels of 64 features in the
//   128-byte-swizzled layout, both read MN-major through bf16 wgmma's
//   transpose bits; a stage's barrier counts a producer thread once its
//   copies land (cp.async.mbarrier.arrive), so every free stage of the ring
//   is in flight. g is gathered over the present pairs only: pairs x Fo x
//   2 bytes a F tile. The tile (64 * MT features x BN outputs, from the
//   wrapper: the one that gathers the fewest bytes a pair) is split between
//   the two consumer warpgroups by features (MT = 2), by output panels
//   (MT = 1, BN = 128) or by k16 steps (MT = 1, BN = 64; each warpgroup
//   then writes a partial of its own). Consumers keep one wgmma group in
//   flight and release a stage after the next wait; the wgmma sums are
//   added into f32 sums every 32 k16 steps and at the end of each piece
//   (the stages of one unit within one range), and a piece's sums go to
//   its own slot of f32 partials (slot unit + range: unique, since the
//   units of later ranges never come before those of earlier ones); loop
//   conditions around wgmma are warp votes (no C7518);
// - wgrad_bf16_reduce: dw[t][f][o] = the unit's pieces' partials added in
//   range order (and warpgroup order), zero for a tap no row has.
// No float atomics: the result is bit-identical from run to run. A tap
// absent at a row adds nothing at all, so a non-finite g value at a row
// reaches only the taps the row has (the plain version's dense product
// would spread it to every tap).
// The entry points return cudaGetLastError() (or cudaErrorInvalidValue for
// what they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTaps = 27;
constexpr int kThreads = 384;   // warpgroups 0, 1 consume, 2 gathers
constexpr int kFlushSteps = 32;  // k steps between flushes of the sums

// ---- sparse_conv_f32_wgrad (K6) --------------------------------------------

constexpr int kRing = 204800;   // bytes of shared memory for the ring
// registers a thread after the hand-over: the producer keeps 40, each
// consumer takes 232 (2 x 128 x 232 + 128 x 40 = 384 x 168, the pool of a
// block launched with 168 a thread)
constexpr int kProducerRegs = 40, kConsumerRegs = 232, kLaunchRegs = 168;
constexpr int kRows = 32;        // voxel rows a stage: one 128-byte span of
                                 // g^T's pack
constexpr int kMaxChunks = 512;  // stages a range holds at most (16,384 rows)

// FT features (A, M) and BN output features (B, N) a block. A stage holds
// the B boxes' hi and lo (BN x 32 rows each) and then the gathered rows,
// FT + 8 floats a row.
template <int FT, int BN>
struct K6Tile {
  static constexpr int kPitch = FT + 8;  // floats a staged row
  static constexpr int kA = kRows * kPitch * 4;
  static constexpr int kB = BN * 128;
  static constexpr int kAOff = 2 * kB;
  static constexpr int kStage = kA + 2 * kB;
  static constexpr int kStages = kRing / kStage > 8 ? 8 : kRing / kStage;
  // k steps of a stage each consumer warpgroup takes
  static constexpr int kSteps = FT == 128 ? 4 : 2;
  // ring, barriers, chunk list and its count, room to align to 1 KB
  static constexpr int kSmem =
      kStages * kStage + 2 * 8 * kStages + 4 * (kMaxChunks + 1) + 1024;
  static_assert(kStage % 1024 == 0, "B boxes need 1 KB alignment");
};

struct K6Args {
  const float* feats;  // [B, C, F]
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

template <int FT, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_wgrad_kernel(const __grid_constant__ CUtensorMap tmg,
                        const K6Args a) {
  using T = K6Tile<FT, BN>;
  constexpr int kR = kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStage);
  uint64_t* empty = full + T::kStages;
  int* sList = reinterpret_cast<int*>(empty + T::kStages);
  int* sCount = sList + kMaxChunks;

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
    const long long row = r_begin + (long long)c * kR + lane;
    const int src = row < r_end ? a.nbr[row * kTaps + t] : -1;
    const bool any = __ballot_sync(0xffffffffu, src >= 0) != 0u;
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
    // ---- producer: 4 threads a row, thread 0 the B boxes ----
    hop::setmaxnreg_dec<kProducerRegs>();
    constexpr int kPerRow = 128 / kR;
    const int p = tid - 256, prow = p / kPerRow, part = p % kPerRow;
    if (p == 0) hop::prefetch_map(&tmg);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < count; ++it) {
      hop::mbar_wait(&empty[stage], phase ^ 1);
      const long long r0 = r_begin + (long long)sList[it] * kR;
      uint8_t* st = ring + stage * T::kStage;
      if (p == 0) {  // g^T's hi and lo: [2, Fo, rows]
        hop::mbar_expect_tx(&full[stage], 2 * T::kB);
        hop::tma_load_3d(st, &tmg, &full[stage], static_cast<int>(r0), n0,
                         0);
        hop::tma_load_3d(st + T::kB, &tmg, &full[stage],
                         static_cast<int>(r0), n0, 1);
      }
      const long long row = r0 + prow;
      const int src = row < r_end ? a.nbr[row * kTaps + t] : -1;
      const float* frow =
          a.feats + ((row / a.C) * a.C + (src >= 0 ? src : 0)) * a.F + f0;
      // row-major staging, a quarter of the row's 16-byte chunks each
      float* dst = reinterpret_cast<float*>(st + T::kAOff) + prow * T::kPitch;
#pragma unroll
      for (int j = 0; j < FT / 16; ++j) {
        const int c = (4 * j + part) * 4;
        const bool ok = src >= 0 && f0 + c < a.F;
        hop::cp_async16(dst + c, ok ? frow + c : a.feats, ok);
      }
      hop::cp_async_arrive(&full[stage]);
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
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
        const uint64_t dh = hop::make_desc(st + 32 * (k0 + kk), 128, 16, 1024);
        const uint64_t dl =
            hop::make_desc(st + T::kB + 32 * (k0 + kk), 128, 16, 1024);
        // the small terms first; the first product after a flush restarts
        hop::WgmmaTf32<BN>::rs(acc, al[kk], dh, since == 0 && kk == 0 ? 0 : 1);
        hop::WgmmaTf32<BN>::rs(acc, ah[kk], dl, 1);
        hop::WgmmaTf32<BN>::rs(acc, ah[kk], dh, 1);
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

template <int FT, int BN>
cudaError_t launch_tile(unsigned blocks, cudaStream_t stream,
                        const CUtensorMap& tmg, const K6Args& a) {
  return hop_host::launch_handover<&sparse_wgrad_kernel<FT, BN>>(
      K6Tile<FT, BN>::kSmem, blocks, kThreads, kLaunchRegs, stream, tmg, a);
}

// ---- sparse_conv_bf16_wgrad ------------------------------------------------

namespace bw {

constexpr int kPairs = 128;       // present pairs a stage: eight k16 steps
constexpr int kChunk = 8;         // stages of pair indices copied at a time
constexpr int kMaxSegs = 128;     // segments of the pair lists at most
constexpr int kSlice = 512;       // rows of nbr a pairs block holds at a time
constexpr int kPairThreads = 1024;  // warp t compacts tap t
constexpr int kSliceSmem = kSlice * kTaps * 4;
constexpr int kMaxRanges = 1024;
constexpr int kRing = 196608;     // bytes of shared memory for the ring
// warpgroups 0, 1 consume, 2, 3 gather (with one producer warpgroup the
// gathers ran about 15 % slower on that card); registers a thread after the
// hand-over: each producer keeps 80, each consumer takes 176 (2 x 128 x 176
// + 2 x 128 x 80 = 512 x 128, the pool of a block launched with 128 a
// thread)
constexpr int kBlockThreads = 512, kProducers = 256;
constexpr int kProducerRegs = 80, kConsumerRegs = 176, kLaunchRegs = 128;

constexpr int kPanel = kPairs * 128;  // 128 rows x 64 features, swizzled

// 64 * MT features (A) and BN output features (B) a tile; a stage holds the
// MT A panels, then the BN / 64 B panels.
template <int MT, int BN>
struct Tile {
  static constexpr int kNB = BN / 64;
  static constexpr int kStage = (MT + kNB) * kPanel;
  static constexpr int kStages = kRing / kStage;  // 6, 4 or 3
  // MT = 1, BN = 64: the warpgroups split each stage's k16 steps, and each
  // writes a partial slot of its own; otherwise they split the tile
  static constexpr bool kKSplit = MT == 1 && BN == 64;
  static constexpr int kNW = MT == 2 ? BN : 64;  // N of a warpgroup's product
  static constexpr int kSteps = kPairs / 16 / (kKSplit ? 2 : 1);  // a stage's
  static constexpr int kFlush = kFlushSteps / kSteps;  // stages a flush
  static constexpr int kSlots = kKSplit ? 2 : 1;       // partial slots a piece
  static constexpr int kIdx = 2 * kChunk * kPairs * 2;  // [2][8][128][2]
  static constexpr int kTables = kTaps * (kMaxSegs + 1) + 3 * kTaps + 1 + 4;
  // ring, barriers, pair indices, tables, room to align to 1 KB
  static constexpr int kSmem = kStages * kStage + 2 * 8 * kStages +
                               4 * (kIdx + kTables) + 1024;
  static_assert(kStage % 1024 == 0, "panels need 1 KB alignment");
  static_assert(kSmem <= 232448, "shared memory");
};

struct Args {
  const __nv_bfloat16* feats;  // [rows, F]
  const __nv_bfloat16* g;      // [rows, Fo]
  const int* pairs;            // int32 [27, rows_pad, 2]: (row, source row)
  const int* segcnt;           // int32 [27, nseg]: pairs a segment
  int* totals;                 // int32 [27]: pairs a tap
  float* partial;              // f32 [slots, 64 * MT, BN]
  long long rows_pad;          // nseg * seg
  int F, Fo, seg, nseg, n_tiles, combos, ranges;
};

// The cut: S stages, ranges of L stages (R of them, the last maybe
// shorter); R = 0 where no pair exists.
__device__ __forceinline__ void cut(int stap, int combos, int ranges,
                                    int& S, int& L, int& R) {
  S = stap * combos;
  if (S == 0) {
    L = 1;
    R = 0;
    return;
  }
  R = min(ranges, S);
  L = (S + R - 1) / R;
  R = (S + L - 1) / L;
}

// Warp 0: from each tap's pairs (lane t's `cnt`), its stages and their
// first stage within a unit; returns the stages of a unit on every lane.
__device__ __forceinline__ int tap_table(int cnt, int lane, int* stg,
                                         int* start) {
  const int st = lane < kTaps ? (cnt + kPairs - 1) / kPairs : 0;
  int incl = st;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane < kTaps) {
    stg[lane] = st;
    start[lane] = incl - st;
  }
  const int stap = __shfl_sync(0xffffffffu, incl, kTaps - 1);
  if (lane == 0) start[kTaps] = stap;
  return stap;
}

// A block's walk over its ranges r = b, b + G, ...: global stage s of range
// r (ending at `end`), unit (combo c, tap t) with its F and N offsets, stage
// ls of the unit, and the stages left in the piece (this one included).
struct Walk {
  int r, s, end, c, t, ls, left, f0, n0;
};

struct Cut {
  const int* stg;
  const int* start;
  int stap, S, L, R, G, n_tiles, ft, bn;

  __device__ __forceinline__ void seek(Walk& w) const {
    w.c = w.s / stap;
    const int x = w.s - w.c * stap;
    int t = 0;
    while (start[t + 1] <= x) ++t;  // past the taps no row has
    w.t = t;
    w.ls = x - start[t];
    w.left = min(w.end - w.s, stg[t] - w.ls);
    w.f0 = w.c / n_tiles * ft;
    w.n0 = w.c % n_tiles * bn;
  }
  __device__ __forceinline__ void begin(Walk& w, int r) const {
    w.r = r;
    if (r < R) {
      w.s = r * L;
      w.end = min(S, w.s + L);
      seek(w);
    }
  }
  // the next stage: a new piece where this one ends (its range or unit)
  __device__ __forceinline__ void next(Walk& w) const {
    ++w.s;
    ++w.ls;
    if (--w.left == 0) {
      if (w.s == w.end)
        begin(w, w.r + G);
      else
        seek(w);
    }
  }
};

// Per segment of `seg` rows, per tap: the (row, source row) pairs whose tap
// is present, in row order, at the segment's slice of the tap's list, and
// their count. Slices of 512 rows of nbr go to shared memory as 16-byte
// vectors, all of a thread's loads in flight at once; warp t compacts tap t.
__global__ void __launch_bounds__(kPairThreads)
    wgrad_pairs_kernel(const int* __restrict__ nbr, int* __restrict__ pairs,
                       int* __restrict__ segcnt, int rows, int C, int seg,
                       int nseg, long long rows_pad) {
  extern __shared__ int4 sv[];  // [kSlice * 27 / 4]
  int* sn = reinterpret_cast<int*>(sv);
  const int k = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
  const int t = tid / 32;
  const int r_begin = k * seg, r_end = min(rows, r_begin + seg);
  int2* out = reinterpret_cast<int2*>(pairs) +
              (long long)min(t, kTaps - 1) * rows_pad + (long long)k * seg;
  int count = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kSlice) {
    const int nr = min(kSlice, r_end - r0), n = nr * kTaps;
    const int* src = nbr + (long long)r0 * kTaps;
    constexpr int kVec =
        (kSlice * kTaps / 4 + kPairThreads - 1) / kPairThreads;
    int4 v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = tid + j * kPairThreads;
      if (i < n / 4) v[j] = reinterpret_cast<const int4*>(src)[i];
    }
    __syncthreads();  // the previous slice is compacted
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = tid + j * kPairThreads;
      if (i < n / 4) sv[i] = v[j];
    }
    if (tid < n % 4) sn[n / 4 * 4 + tid] = src[n / 4 * 4 + tid];
    __syncthreads();
    if (t < kTaps) {
#pragma unroll 4
      for (int j = 0; j < nr; j += 32) {
        const int i = j + lane;
        const int nb = i < nr ? sn[i * kTaps + t] : -1;
        const unsigned bits = __ballot_sync(0xffffffffu, nb >= 0);
        if (nb >= 0) {
          const int row = r0 + i;
          out[count + __popc(bits & ((1u << lane) - 1u))] =
              make_int2(row, row / C * C + nb);
        }
        count += __popc(bits);
      }
    }
  }
  if (t < kTaps && lane == 0) segcnt[t * nseg + k] = count;
}

template <int MT, int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
    wgrad_bf16_kernel(const Args a) {
  using T = Tile<MT, BN>;
  constexpr int kFT = 64 * MT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStage);
  uint64_t* empty = full + T::kStages;
  // [2][chunk][pairs][2]
  int* sIdx = reinterpret_cast<int*>(empty + T::kStages);
  int* sSeg = sIdx + T::kIdx;         // [27][kMaxSegs + 1]: segment prefix
  int* sCnt = sSeg + kTaps * (kMaxSegs + 1);  // [27] pairs a tap
  int* sStg = sCnt + kTaps;           // [27] stages a tap
  int* sStart = sStg + kTaps;         // [28] a tap's first stage in a unit
  int* sCut = sStart + kTaps + 1;     // S, L, R
  constexpr int kSegPitch = kMaxSegs + 1;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) {
    for (int i = 0; i < T::kStages; ++i) {
      hop::mbar_init(&full[i], kProducers);  // the producer threads' copies
      hop::mbar_init(&empty[i], 8);   // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  // the segments' counts (every load in flight at once), then their prefix
  // per tap (4 segments a lane), then the taps' stages (warp 0)
  const int ns = a.nseg;
  {
    constexpr int kLoads =
        (kTaps * kMaxSegs + kBlockThreads - 1) / kBlockThreads;
    int v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kBlockThreads;
      v[j] = i < kTaps * ns ? a.segcnt[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kBlockThreads;
      if (i < kTaps * ns) sSeg[(i / ns) * kSegPitch + i % ns + 1] = v[j];
    }
  }
  if (tid < kTaps) sSeg[tid * kSegPitch] = 0;
  __syncthreads();
  for (int t = warp; t < kTaps; t += kBlockThreads / 32) {
    int* row = sSeg + t * kSegPitch + 1;
    int v[4], local = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * lane + e;
      local += k < ns ? row[k] : 0;
      v[e] = local;
    }
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * lane + e;
      if (k < ns) row[k] = incl - local + v[e];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int cnt = lane < kTaps ? sSeg[lane * kSegPitch + ns] : 0;
    if (lane < kTaps) {
      sCnt[lane] = cnt;
      if (blockIdx.x == 0) a.totals[lane] = cnt;
    }
    const int stap = tap_table(cnt, lane, sStg, sStart);
    if (lane == 0) {
      int S, L, R;
      cut(stap, a.combos, a.ranges, S, L, R);
      sCut[0] = S;
      sCut[1] = L;
      sCut[2] = R;
    }
  }
  __syncthreads();
  const Cut cutp{sStg,     sStart,    sStart[kTaps], sCut[0], sCut[1],
                 sCut[2],  static_cast<int>(gridDim.x), a.n_tiles, kFT, BN};
  if (static_cast<int>(blockIdx.x) >= cutp.R) return;

  const int wg = tid / 128;
  if (wg >= 2) {
    // ---- producers: each 128-byte row of a stage's panels by 8 lanes (one
    // 16-byte chunk each), so that a warp's copy touches 4 rows: thread p
    // copies chunk p % 8 of rows p / 8 + 32 k of every panel ----
    hop::setmaxnreg_dec<kProducerRegs>();
    const int p = tid - 256, pp = p % kPairs, c8 = p % 8, r8 = p / 8;
    const bool side_a = p < kPairs;
    constexpr int kRowStep = kProducers / 8, kRowsEach = kPairs / kRowStep;
    // the stages' pairs (row, source row), 8 stages at a time into
    // sIdx[buf][stage][128] (int2): thread p copies the row (p >= 128) or
    // the source row of pair p % 128 from the compacted lists: pair q of
    // tap t lies in segment k, the last whose prefix is <= q; a cursor
    // (unit, k) moves with q and is found anew by bisection where the walk
    // enters another unit
    Walk iw;
    cutp.begin(iw, blockIdx.x);
    int cu = -1, ck = 0;
    auto copy_chunk = [&](int buf) {
#pragma unroll 1
      for (int i = 0; i < kChunk; ++i) {
        int* dst = sIdx + 2 * ((buf * kChunk + i) * kPairs + pp) + side_a;
        const int* src = a.pairs;
        bool ok = false;
        if (iw.r < cutp.R) {
          const int q = kPairs * iw.ls + pp;
          if (q < sCnt[iw.t]) {
            const int* so = sSeg + iw.t * kSegPitch;
            const int unit = iw.c * kTaps + iw.t;
            if (unit != cu) {
              cu = unit;
              int lo = 0, hi = ns - 1;
              while (lo < hi) {
                const int mid = (lo + hi + 1) / 2;
                if (so[mid] <= q)
                  lo = mid;
                else
                  hi = mid - 1;
              }
              ck = lo;
            }
            while (so[ck + 1] <= q) ++ck;
            src = a.pairs + 2 * ((long long)iw.t * a.rows_pad +
                                 (long long)ck * a.seg + (q - so[ck])) +
                  side_a;
            ok = true;
          }
          cutp.next(iw);
        }
        hop::cp_async4(dst, src, ok);
      }
      hop::cp_async_commit();
    };
    copy_chunk(0);
    Walk w;
    cutp.begin(w, blockIdx.x);
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (; w.r < cutp.R; ++it) {
      const int i = it % kChunk, buf = (it / kChunk) & 1;
      if (i == 0) {
        // this chunk's indices have landed (the last group committed, with
        // the gathers of the chunk before the last, holds them), for every
        // producer thread
        hop::cp_async_wait<0>();
        hop::named_barrier(1, kProducers);
      }
      const int2* ids =
          reinterpret_cast<const int2*>(sIdx) + (buf * kChunk + i) * kPairs;
      const int n_valid = sCnt[w.t] - kPairs * w.ls;  // pairs of the stage
      hop::mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* st = ring + stage * T::kStage;
#pragma unroll
      for (int k = 0; k < kRowsEach; ++k) {
        const int r = r8 + kRowStep * k;
        const int2 id = ids[r];
        const bool valid = r < n_valid;
        uint8_t* at = st + r * 128 + ((c8 ^ (r8 % 8)) * 16);  // swizzled
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int f = w.f0 + 64 * m + 8 * c8;
          const bool ok = valid && f < a.F;
          hop::cp_async16(at + m * kPanel,
                          ok ? a.feats + (long long)id.y * a.F + f : a.feats,
                          ok);
        }
#pragma unroll
        for (int m = 0; m < T::kNB; ++m) {
          const int o = w.n0 + 64 * m + 8 * c8;
          const bool ok = valid && o < a.Fo;
          hop::cp_async16(at + (MT + m) * kPanel,
                          ok ? a.g + (long long)id.x * a.Fo + o : a.g, ok);
        }
      }
      // the stage's barrier counts this thread once its copies have
      // landed; the thread goes on to the next stage
      hop::cp_async_arrive(&full[stage]);
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
      // the next chunk's indices, into the other buffer, which every
      // producer thread has read (they all passed this chunk's barrier)
      if (i == 0) copy_chunk(buf ^ 1);
      cutp.next(w);
    }
    hop::cp_async_wait<0>();  // the index copies past the walk
  } else {
    // ---- consumers ----
    hop::setmaxnreg_inc<kConsumerRegs>();
    constexpr int kNW = T::kNW;
    const int wt = tid % 128, w4 = wt / 32, g = lane / 4, q = lane % 4;
    // this warpgroup's A panel, B panel and first k16 step of a stage
    const int ap = MT == 2 ? wg : 0;
    const int bp = MT == 1 && BN == 128 ? wg : 0;
    const int k0 = T::kKSplit ? T::kSteps * wg : 0;
    float acc[kNW / 2], sum[kNW / 2];
#pragma unroll
    for (int i = 0; i < kNW / 2; ++i) acc[i] = sum[i] = 0.f;
    Walk w;
    cutp.begin(w, blockIdx.x);
    int stage = 0, prev = 0, since = 0, it = 0;
    uint32_t phase = 0;
    // the loop and its flushes hold wgmma instructions: their conditions
    // are warp votes, which ptxas knows to be uniform (C7518)
    for (; __any_sync(0xffffffffu, w.r < cutp.R); ++it) {
      const bool last = w.left == 1;
      hop::mbar_wait(&full[stage], phase);
      // the producer's cp.async wrote the stage through the generic proxy
      // and wgmma reads it through the async proxy
      hop::fence_proxy_async();
      const uint8_t* sa = ring + stage * T::kStage + ap * kPanel;
      const uint8_t* sb = ring + stage * T::kStage + (MT + bp) * kPanel;
      // no access to acc between here and the wait below: the products of
      // consecutive stages chain into it while the previous ones run
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {  // a k16 step is 16 rows
        const int off = (k0 + kk) * 2048;
        hop::WgmmaT<kNW>::ss(acc, hop::make_desc(sa + off, 128, kPanel, 1024),
                             hop::make_desc(sb + off, 128, kPanel, 1024),
                             since == 0 && kk == 0 ? 0 : 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the previous stage's products are done
      if (it > 0 && lane == 0) hop::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
      ++since;
      if (__any_sync(0xffffffffu, since == T::kFlush || last)) {
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
#pragma unroll
        for (int i = 0; i < kNW / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
        since = 0;
      }
      if (__any_sync(0xffffffffu, last)) {
        // the piece's sums to its slot (unit + range): features 64 ap +
        // 16 w4 + g (+ 8), outputs 64 bp + 8 j + 2 q (+ 1) of the tile
        const int slot = (w.c * kTaps + w.t + w.r) * T::kSlots +
                         (T::kKSplit ? wg : 0);
        float* out = a.partial + (long long)slot * kFT * BN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* orow = out + (64 * ap + 16 * w4 + g + 8 * h) * BN + 64 * bp;
#pragma unroll
          for (int j = 0; j < kNW / 8; ++j) {
            *reinterpret_cast<float2*>(orow + 8 * j + 2 * q) =
                make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
          }
        }
#pragma unroll
        for (int i = 0; i < kNW / 2; ++i) sum[i] = 0.f;
      }
      cutp.next(w);
    }
    hop::wgmma_wait<0>();  // (done at the last flush; said for ptxas)
    if (it > 0 && lane == 0) hop::mbar_arrive(&empty[prev]);
  }
}

// dw[t][f][o], 4 outputs a thread: the pieces of unit
// (F tile, N tile, t) in range order, each piece's slots in order; 0 for a
// tap no row has.
__global__ void __launch_bounds__(256)
    wgrad_bf16_reduce_kernel(const float* __restrict__ partial,
                             const int* __restrict__ totals,
                             float* __restrict__ dw, int F, int Fo, int ft,
                             int bn, int n_tiles, int combos, int ranges,
                             int slots) {
  __shared__ int sStg[kTaps], sStart[kTaps + 1], sL;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int stap = tap_table(lane < kTaps ? totals[lane] : 0, lane, sStg,
                               sStart);
    if (lane == 0) {
      int S, L, R;
      cut(stap, combos, ranges, S, L, R);
      sL = L;
    }
  }
  __syncthreads();
  const int stap = sStart[kTaps], L = sL;
  const long long n4 = (long long)kTaps * F * Fo / 4;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    const long long e = 4 * i;
    const int t = static_cast<int>(e / ((long long)F * Fo));
    const int rem = static_cast<int>(e - (long long)t * F * Fo);
    const int f = rem / Fo, o = rem % Fo;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (sStg[t] > 0) {
      const int c = f / ft * n_tiles + o / bn;
      const int first = c * stap + sStart[t];
      const int r0 = first / L, r1 = (first + sStg[t] - 1) / L;
      // the unit's slots, in order: (unit + r) * slots + h for r = r0 ..
      // r1, h < slots; 4 loads in flight at a time
      const float* base = partial + (f % ft) * bn + o % bn +
                          ((long long)(c * kTaps + t + r0) * slots) * ft * bn;
      const int n = (r1 - r0 + 1) * slots;
      for (int j0 = 0; j0 < n; j0 += 4) {
        float4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j0 + j < n)
            v[j] = *reinterpret_cast<const float4*>(
                base + (long long)(j0 + j) * ft * bn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j0 + j >= n) break;
          if (j0 + j == 0) {
            sum = v[j];
          } else {
            sum.x += v[j].x;
            sum.y += v[j].y;
            sum.z += v[j].z;
            sum.w += v[j].w;
          }
        }
      }
    }
    *reinterpret_cast<float4*>(dw + e) = sum;
  }
}

template <int MT, int BN>
cudaError_t launch(unsigned blocks, cudaStream_t stream, const Args& a) {
  return hop_host::launch_handover<&wgrad_bf16_kernel<MT, BN>>(
      Tile<MT, BN>::kSmem, blocks, kBlockThreads, kLaunchRegs, stream, a);
}

}  // namespace bw

}  // namespace

extern "C" {

// feats f32 [B, C, F], nbr int32 [B, C, 27], g f32 [B, C, Fo] -> dw f32
// [27, F, Fo]; pack is scratch of 2 * Fo * ld floats (ld = B * C rounded up
// to 4), partial of [S, 27, F, Fo] floats with S = ceil(B * C /
// rows_per_split) (unused, and may be null, where S == 1); rows_per_split is
// a multiple of 32 and at most 16,384.
int sparse_conv_f32_wgrad(const void* feats, const void* nbr, const void* g,
                          void* pack, void* partial, void* dw, int B, int C,
                          int F, int Fo, int rows_per_split, void* stream) {
  if (B <= 0 || C <= 0 || F <= 0 || Fo <= 0 || F % 4 || Fo % 4 ||
      rows_per_split <= 0 || rows_per_split % kRows ||
      rows_per_split > kRows * kMaxChunks ||
      reinterpret_cast<uintptr_t>(feats) % 16 ||
      reinterpret_cast<uintptr_t>(pack) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * C;
  const long long S = (rows + rows_per_split - 1) / rows_per_split;
  if (rows >= (1LL << 31) || (S > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ft = F <= 64 ? 64 : 128, bn = Fo <= 64 ? 64 : 128;
  K6Args a;
  a.feats = static_cast<const float*>(feats);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // g^T's tf32 hi and lo, and its map: boxes of 32 rows by the N tile
  const long long ld = (rows + 3) / 4 * 4;
  sparse_wgrad_pack_kernel<<<dim3(static_cast<unsigned>((ld + 31) / 32),
                                  static_cast<unsigned>((Fo + 31) / 32)),
                             dim3(32, 8), 0, st>>>(
      static_cast<const float*>(g), static_cast<float*>(pack), rows, Fo, ld);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t dims[3] = {(uint64_t)ld, (uint64_t)Fo, 2};
  const uint64_t strides[2] = {(uint64_t)ld * 4, (uint64_t)ld * Fo * 4};
  const uint32_t box[3] = {(uint32_t)kRows, (uint32_t)bn, 1};
  CUtensorMap tmg;
  if (!hop_host::make_map(&tmg, pack, 3, dims, strides, box, 128,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  e = ft == 64 ? (bn == 64 ? launch_tile<64, 64>(nb, st, tmg, a)
                           : launch_tile<64, 128>(nb, st, tmg, a))
               : (bn == 64 ? launch_tile<128, 64>(nb, st, tmg, a)
                           : launch_tile<128, 128>(nb, st, tmg, a));
  if (e != cudaSuccess || S == 1) return static_cast<int>(e);
  const long long n4 = (long long)kTaps * F * Fo / 4;
  sparse_wgrad_reduce_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256,
                               0, st>>>(static_cast<const float*>(partial),
                                        static_cast<float*>(dw), n4,
                                        static_cast<int>(S));
  return static_cast<int>(cudaGetLastError());
}

// feats bf16 [B, C, F], nbr int32 [B, C, 27], g bf16 [B, C, Fo] -> dw f32
// [27, F, Fo]; F and Fo multiples of 8. The plan comes from the wrapper:
// the tile mt in {1, 2}, bn in {64, 128} (64 * mt features by bn outputs),
// segments of `seg` rows (a multiple of 512, at most 128 of them) and at
// most `ranges` ranges (1 .. 1,024). work is int32 scratch of 2 * 27 *
// rows_pad (the pair lists, rows_pad = ceil(B * C / seg) * seg) + 27 *
// nseg (the segments' counts) + 27 (the totals) ints; partial is f32
// scratch of (27 * combos + ranges) * slots * 64 * mt * bn floats (combos =
// F tiles x N tiles, slots 2 for mt = 1, bn = 64, else 1).
int sparse_conv_bf16_wgrad(const void* feats, const void* nbr, const void* g,
                           void* work, void* partial, void* dw, int B, int C,
                           int F, int Fo, int mt, int bn, int seg, int ranges,
                           void* stream) {
  const long long rows = (long long)B * C;
  const bool tile_ok = (mt == 1 || mt == 2) && (bn == 64 || bn == 128);
  if (B <= 0 || C <= 0 || F <= 0 || Fo <= 0 || F % 8 || Fo % 8 || !tile_ok ||
      rows >= (1LL << 31) || seg <= 0 || seg % bw::kSlice ||
      ranges < 1 || ranges > bw::kMaxRanges)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {feats, nbr, g, static_cast<const void*>(work),
                        static_cast<const void*>(partial),
                        static_cast<const void*>(dw)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  const long long nseg = (rows + seg - 1) / seg;
  const int f_tiles = (F + 64 * mt - 1) / (64 * mt);
  const int n_tiles = (Fo + bn - 1) / bn;
  const long long combos = (long long)f_tiles * n_tiles;
  // stage indices (and piece slots) are ints
  if (nseg > bw::kMaxSegs ||
      combos * kTaps * ((rows + 63) / 64) + ranges >=
          (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bw::Args a;
  a.feats = static_cast<const __nv_bfloat16*>(feats);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.rows_pad = nseg * seg;
  int* pairs = static_cast<int*>(work);
  int* segcnt = pairs + 2 * kTaps * a.rows_pad;
  a.pairs = pairs;
  a.segcnt = segcnt;
  a.totals = segcnt + kTaps * nseg;
  a.partial = static_cast<float*>(partial);
  a.F = F;
  a.Fo = Fo;
  a.seg = seg;
  a.nseg = static_cast<int>(nseg);
  a.n_tiles = n_tiles;
  a.combos = static_cast<int>(combos);
  a.ranges = ranges;
  static const cudaError_t attr =
      hop_host::allow_smem(bw::wgrad_pairs_kernel, bw::kSliceSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bw::wgrad_pairs_kernel<<<static_cast<unsigned>(nseg), bw::kPairThreads,
                           bw::kSliceSmem, st>>>(
      static_cast<const int*>(nbr), pairs, segcnt, static_cast<int>(rows), C,
      seg, a.nseg, a.rows_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = hop_host::sm_count();
  const unsigned blocks = static_cast<unsigned>(sms < ranges ? sms : ranges);
  e = mt == 1 ? (bn == 64 ? bw::launch<1, 64>(blocks, st, a)
                          : bw::launch<1, 128>(blocks, st, a))
              : (bn == 64 ? bw::launch<2, 64>(blocks, st, a)
                          : bw::launch<2, 128>(blocks, st, a));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = (long long)kTaps * F * Fo / 4;
  const long long rblocks = (n4 + 255) / 256;
  bw::wgrad_bf16_reduce_kernel<<<static_cast<unsigned>(rblocks), 256, 0,
                                 st>>>(
      static_cast<const float*>(partial), a.totals, static_cast<float*>(dw), F,
      Fo, 64 * mt, bn, n_tiles, a.combos, ranges,
      mt == 1 && bn == 64 ? 2 : 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
