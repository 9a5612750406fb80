// Sparse submanifold 3x3x3 convolution on voxel rows for Hopper (sm_90a),
// f32 in and out, behind a plain C interface (loaded with ctypes by
// infinicube_tpu_torch/kernels).
//
// sparse_conv_f32 (K4) replaces the forward of the TPU kernel
//   infinicube_tpu/ops/window_conv.py:222 `_conv_core` (reached through
//   `window_sparse_conv`), which runs every SparseConv3d of the sparse VAE's
//   structure decoder: 12 per decode at (F, Fo) in {(256, 256), (256, 128),
//   (128, 128), (128, 64), (64, 64)} on 32,768 .. 131,072 voxel rows, and
//   24 per step of the VAE trainer.
//   out[b, m] = sum_t feats[b, nbr[b, m, t]] @ w[t]   (absent taps: -1, zero)
//   and every row of a batch element with poison[b] != 0 is NaN (the loud
//   dense-bounds policy of window_conv.py:313). The same kernel is the
//   conv's input gradient (window_conv.py:320 `_wc_bwd`): the output
//   gradient through the reversed, transposed weights, with no poison.
//
// What bounds it: 2 * F * Fo operations per present (row, tap) pair against
// about (F + Fo) * 4 bytes per row, far above the ridge, so operations. The
// release VAE computes in f32; on the CUDA cores (67 TFLOP/s on an H100
// SXM) the first version reached 10-24 % of that bound with Hopper's tensor
// cores idle.
//
// Design: f32-accurate products on the tensor cores by the 3xTF32 split.
// Each operand a becomes hi = tf32(a) (the low 13 mantissa bits cleared)
// and lo = tf32(a - hi); the kernel accumulates lo_A hi_B + hi_A lo_B +
// hi_A hi_B in f32 on wgmma m64nNk8 .f32.tf32.tf32 and drops lo_A lo_B
// (about 2^-22 of the product); one TF32 product alone keeps about three
// decimal digits. Three products at 495 TFLOP/s bound it at 165 TFLOP/s of
// f32 work, 2.5x the CUDA cores' peak.
// - The TPU kernel's window plan (directional windows, one-hot selection
//   matmuls, a miss list with an exact fallback) worked around the TPU's
//   slow gathers. Here a tile of 128 voxel rows walks only the taps some of
//   its rows have; nothing is missed and no fallback exists.
// - TMA cannot gather rows on Hopper, so a producer warpgroup gathers them:
//   each of its 128 threads copies its row's 128 bytes of the stage (eight
//   16-byte cp.async, src-size 0 for an absent neighbour) into a ring of
//   stages, straight into the K-major 128-byte-swizzled layout wgmma reads,
//   and signals the stage's mbarrier when its copies land.
// - tf32 wgmma takes both operands K-major, so the weights come packed
//   [2, 27, N, K] (hi and lo of w[t]^T, made once per weight version by the
//   caller), one 2-D TMA box each per stage on the same mbarrier.
// - The two consumer warpgroups (64 rows each, the whole N tile of up to
//   128 features, f32 accumulators in registers) split their own rows of
//   each arrived stage into hi (in place) and lo in shared memory, then
//   issue the three products per k8 step.
// - The tensor cores truncate (round toward zero) every sum they
//   accumulate, and a row sums up to 27 x F/8 k8 steps: the wgmma sums are
//   added into f32 sums with a rounded add every 32 k8 steps and restarted
//   (scale-d 0), as the f32 conv and K6 do. Both sums live in registers;
//   the producer hands its registers to the consumers (setmaxnreg).
// - Blocks are persistent, one an SM, and take work items (batch element,
//   row tile, N tile) from a queue, each 8 stages before the end of the
//   item they run (its rows of the neighbour table load into registers
//   meanwhile); a block takes an item only as it frees up, so the last
//   items go to the SMs that finish first. For each item the producer
//   warpgroup ORs the taps present over the tile and hands the stage count
//   to the consumers through a two-slot mbarrier handshake; a tile of
//   padding slots (no tap) costs no stage, and its rows get zeros (NaN for
//   a poisoned element). The ring runs on from one item to the next, so a
//   tile's gathers overlap the previous tile's products and store.
//
// sparse_conv_bf16 replaces the same `_conv_core` on bf16 features (the
// GSM's voxel branch in gsm_bf16_config: ten convs a forward at (F, Fo) in
// {64, 128, 256} and the decoder's 384 -> 128 and 192 -> 64), and as the
// input gradient `_wc_bwd`'s dx on a bf16 output gradient. It computes what
// `_conv_kernel` computes: every tap's bf16 product added into f32 sums,
// rounded to bf16 once (window_conv.py:173). Bound by operations (2 * F *
// Fo per present pair at 989 TFLOP/s against (F + Fo) * 2 bytes a row),
// a few microseconds on the GSM's levels. What holds it back is data
// movement from L2: each row is gathered again for each of its up to 27
// neighbours and each N tile, and each tile reads every tap's weights
// again, so at the levels where tiles are many a stage moves 24-32 KB
// and the SMs together run near L2's rate; where tiles are few, the
// latency of a tile's stages one after another; one block a tile (512 row
// tiles at every level, however few are active) and a producer thread that
// waits for its own copies would add to it. Design: one kernel
// template over the element type (Tf32x3, Bf16 below): K4's gather,
// persistent walk, ring, flushes and store, without the split:
// - each producer thread gathers its row's 64 features of a stage (128
//   bytes) with cp.async into the same swizzled K-major layout and, as in
//   f32, the stage's barrier counts its arrival once the copies land
//   (cp.async.mbarrier.arrive): a thread never waits for its own copies,
//   so it keeps as many stages in flight as the ring has free; wgmma reads
//   shared memory through the async proxy, so a consumer fences the proxy
//   after the barrier made the copies visible to it;
// - the weights come packed [27, N, K] bf16 (w[t]^T per tap, made once
//   per weight version by the caller), one 2-D TMA box per stage;
// - one wgmma m64nNk16 .f32.bf16.bf16 per k16 step, four a stage, chained
//   from stage to stage with nothing touching the accumulators between a
//   stage's issue and the next wait; the conditions of the loops around
//   them are warp votes (conditions on values read from shared memory made
//   ptxas take the path as divergent and serialize every wgmma, C7518); the
//   wgmma sums are added into f32 sums with a rounded add every 32 k16
//   steps, as K4 does, and rounded to bf16 once at the store.
// The entry points return cudaGetLastError() (or cudaErrorInvalidValue for
// what they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;      // voxel rows per tile
constexpr int kTaps = 27;
constexpr int kThreads = 384;   // warpgroups 0, 1 consume, 2 gathers
constexpr int kSpan = 128;      // bytes of a stage's row
constexpr int kRing = 196608;   // bytes of shared memory for the ring
constexpr int kFlushSteps = 32;  // k steps between flushes of the sums
constexpr int kFlush = kFlushSteps / (kSpan / 32);  // stages between them
// registers a thread after the hand-over: the producer keeps 72 (its row of
// the next tile's neighbour table, 27, rides through a tile), each
// consumer takes 216 (2 x 128 x 216 + 128 x 72 = 384 x 168, the pool of a
// block launched with 168 a thread)
constexpr int kProducerRegs = 72, kConsumerRegs = 216, kLaunchRegs = 168;

// The element types. A k step reads 32 bytes of a row: k8 in f32, k16 in
// bf16, four a stage either way.
struct Tf32x3 {  // f32 features: each operand as tf32 hi and lo
  using E = float;
  static constexpr int kParts = 2;  // weight packs and A copies (hi, lo)
  static constexpr int kMaxStages = 6;
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

struct Bf16 {  // bf16 features, one product a k step
  using E = __nv_bfloat16;
  static constexpr int kParts = 1;
  static constexpr int kMaxStages = 8;
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <class Op>
constexpr int kChunk = kSpan / sizeof(typename Op::E);  // features a stage

template <class Op, int BN>
struct K4Tile {
  static constexpr int kA = kRows * kSpan;   // gathered rows (f32: their hi)
  static constexpr int kB = BN * kSpan;      // one weight box
  static constexpr int kStage = Op::kParts * (kA + kB);  // A parts, B parts
  static constexpr int kStages = kRing / kStage > Op::kMaxStages
                                     ? Op::kMaxStages
                                     : kRing / kStage;
  // ring, stage and tile barriers, the producer's neighbour table, the
  // items' indices and stage counts, the tap masks, and room to align to
  // 1 KB
  static constexpr int kSmem = kStages * kStage + 8 * (2 * kStages + 4) +
                               4 * (kTaps * kRows + 6 + 8) + 1024;
};

// The persistent blocks' work queue: [0] the next work item, [1] the blocks
// done. The last block of a launch puts both back to 0 for the next launch
// on the stream (the port launches these kernels on its current stream;
// launches on two streams of one card at once would share the queue).
__device__ unsigned int g_work_queue[2];

template <typename E>
struct K4Args {
  const E* feats;   // [B, C, K]
  const int* nbr;   // int32 [B, C, 27]
  const int* poison;  // int32 [B]
  E* out;           // [B, C, N]
  int C, K, N;      // rows per batch element, input and output features
  int m_tiles, n_tiles, kc, n_work;
};

__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = tf32_trunc(v);
  lo = tf32_trunc(v - hi);  // v - hi is exact
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Work item w: (batch element, 128-row tile, N tile), the N tile fastest.
// Persistent blocks take the items from a queue as they free up (the
// tiles' stage counts vary from 0 to 27 x K chunks, so a fixed share of
// items per block, or one taken a whole item ahead, leaves some SMs idle
// while others run);
// the ring of stages runs on from one item to the next, so one tile's
// gathers overlap the previous tile's products and store. For each item
// the producer warpgroup finds the taps some row has (its stages: taps x
// K chunks; none for a tile of padding slots or of a poisoned element) and
// hands the count to the consumers, which store zeros, NaN or the sums.
template <class Op, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_conv_kernel(const __grid_constant__ CUtensorMap tmw_hi,
                       const __grid_constant__ CUtensorMap tmw_lo,
                       const K4Args<typename Op::E> a) {
  using T = K4Tile<Op, BN>;
  using E = typename Op::E;
  constexpr int kP = Op::kParts;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStage);
  uint64_t* empty = full + T::kStages;
  uint64_t* tfull = empty + T::kStages;  // [2] an item's stage count is set
  uint64_t* tempty = tfull + 2;          // [2] ... and was read
  int* sN = reinterpret_cast<int*>(tempty + 2);  // [27][128], the producer's
  int* sIters = sN + kTaps * kRows;      // [2] stages of an item, -1 poisoned
  int* sItem = sIters + 2;               // [2] the item, -1 when none is left
  int* sWork = sItem + 2;                // [2] the producer's next item
  unsigned* sMask = reinterpret_cast<unsigned*>(sWork + 2);  // [2][4]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      hop::mbar_init(&full[s], kRows + 1);  // 128 gathers, the weights' tx
      hop::mbar_init(&empty[s], 8);         // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&tfull[i], 1);
      hop::mbar_init(&tempty[i], 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: every thread gathers its row, thread 0 the weights ----
    hop::setmaxnreg_dec<kProducerRegs>();
    const int p = tid - 256, lane = p % 32;
    if (p == 0) {
      hop::prefetch_map(&tmw_hi);
      if constexpr (kP == 2) hop::prefetch_map(&tmw_lo);
    }
    // this thread's row of item w's neighbour table (-1: absent, or a row
    // past C)
    int nxt[kTaps];
    auto load_row = [&](int w) {
      const int mt = w / a.n_tiles % a.m_tiles, b = w / a.n_tiles / a.m_tiles;
      const int m = mt * kRows + p;
      const int* src = a.nbr + ((long long)b * a.C + m) * kTaps;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) nxt[t] = m < a.C ? src[t] : -1;
    };
    constexpr int kPiece = 16 / sizeof(E);  // features a 16-byte cp.async
    int stage = 0;
    uint32_t phase = 0;
    // thread 0 takes the next item from the queue kAhead stages before the
    // current item's last (at once after an item without stages), so that
    // its rows load while those stages go out and the queue still hands
    // items to the blocks that free up first
    constexpr int kAhead = 8;
    int wn = 0;
    auto take_next = [&](int slot) {
      if (p == 0)
        sWork[slot] = static_cast<int>(atomicAdd(&g_work_queue[0], 1u));
      hop::named_barrier(3, 128);
      wn = sWork[slot];
      if (wn < a.n_work) load_row(wn);
    };
    take_next(0);
    int w = wn;
    int i = 0;
    for (; w < a.n_work; ++i) {
      const int nt = w % a.n_tiles, b = w / a.n_tiles / a.m_tiles;
      const int n0 = nt * BN;
      const long long row0 = (long long)b * a.C;
      unsigned bits = 0;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        sN[t * kRows + p] = nxt[t];
        bits |= (nxt[t] >= 0 ? 1u : 0u) << t;
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0) sMask[(i & 1) * 4 + p / 32] = bits;
      hop::named_barrier(3, 128);
      const unsigned* mk = sMask + (i & 1) * 4;
      const bool poisoned = a.poison[b] != 0;
      const unsigned mask = poisoned ? 0u : mk[0] | mk[1] | mk[2] | mk[3];
      const int iters = __popc(mask) * a.kc;
      if (p == 0) {
        hop::mbar_wait(&tempty[i & 1], ((i >> 1) & 1) ^ 1);
        sIters[i & 1] = poisoned ? -1 : iters;
        sItem[i & 1] = w;
        hop::mbar_arrive(&tfull[i & 1]);
      }
      const int take_at = iters > kAhead ? iters - kAhead : 0;
      if (iters == 0) take_next((i + 1) & 1);
      unsigned rest = mask;
      int t = 0;
      for (int it = 0; it < iters; ++it) {
        if (it == take_at) take_next((i + 1) & 1);
        if (it % a.kc == 0) {  // the next present tap
          t = __ffs(rest) - 1;
          rest &= rest - 1;
        }
        const int k0 = (it % a.kc) * kChunk<Op>;
        hop::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * T::kStage;
        if (p == 0) {
          uint8_t* sb = st + kP * T::kA;
          hop::mbar_expect_tx(&full[stage], kP * T::kB);
          hop::tma_load_2d(sb, &tmw_hi, &full[stage], k0, t * a.N + n0);
          if constexpr (kP == 2)
            hop::tma_load_2d(sb + T::kB, &tmw_lo, &full[stage], k0,
                             t * a.N + n0);
        }
        const int src = sN[t * kRows + p];
        const E* row = a.feats + (row0 + (src >= 0 ? src : 0)) * a.K + k0;
        uint8_t* dst = st + p * kSpan;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // 16-byte chunk j at j ^ (row % 8)
          const bool ok = src >= 0 && k0 + kPiece * j < a.K;
          hop::cp_async16(dst + ((j ^ (p % 8)) * 16),
                          ok ? row + kPiece * j : a.feats, ok);
        }
        // the stage's barrier counts this thread's arrival once its
        // copies have landed; the thread goes on to the next stage
        hop::cp_async_arrive(&full[stage]);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      w = wn;
    }
    if (p == 0) {
      hop::mbar_wait(&tempty[i & 1], ((i >> 1) & 1) ^ 1);
      sItem[i & 1] = -1;  // the consumers are done
      hop::mbar_arrive(&tfull[i & 1]);
      // this block takes no more items: the last block to finish resets
      // the queue
      __threadfence();
      if (atomicAdd(&g_work_queue[1], 1u) == gridDim.x - 1) {
        atomicExch(&g_work_queue[0], 0u);
        atomicExch(&g_work_queue[1], 0u);
      }
    }
  } else {
    // ---- consumers: 64 rows each, all BN output features ----
    hop::setmaxnreg_inc<kConsumerRegs>();
    float acc[BN / 2], sum[BN / 2];
    const int wt = tid % 128, lane = tid % 32;
    const int w = wt / 32, g = lane / 4, q = lane % 4;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int i = 0;; ++i) {
      hop::mbar_wait(&tfull[i & 1], (i >> 1) & 1);
      const int wk = sItem[i & 1], iters = sIters[i & 1];
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&tempty[i & 1]);
      if (__any_sync(0xffffffffu, wk < 0)) break;
      const int nt = wk % a.n_tiles, mt = wk / a.n_tiles % a.m_tiles;
      const int b = wk / a.n_tiles / a.m_tiles;
      const int m0 = mt * kRows, n0 = nt * BN;
      // the stage loop and its flushes hold wgmma instructions: their
      // conditions are warp votes, which ptxas knows to be uniform (a
      // condition on a value read from shared memory is divergent to it,
      // and it serializes every wgmma behind such a branch, C7518)
      const float init = iters < 0 ? nanf("") : 0.f;
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) sum[k] = init;
      for (int it = 0; __any_sync(0xffffffffu, it < iters); ++it) {
        const bool first = it % kFlush == 0;  // the products restart the sums
        hop::mbar_wait(&full[stage], phase);
        // bf16: the producer's cp.async wrote the stage through the generic
        // proxy and wgmma reads it through the async proxy; the barrier
        // made the writes visible to this thread, the fence orders them
        // before its wgmma (f32: the split below reads and writes the
        // operands itself and fences them)
        if constexpr (kP == 1) hop::fence_proxy_async();
        uint8_t* st = ring + stage * T::kStage;
        uint8_t* sa = st + wg * 64 * kSpan;
        const uint8_t* sb = st + kP * T::kA;
        if constexpr (kP == 2) {
          // this warpgroup's 64 rows: hi in place, lo beside (the swizzle is
          // the same in both, so elementwise work ignores it)
          float4* ahi = reinterpret_cast<float4*>(sa);
          float4* alo = reinterpret_cast<float4*>(sa + T::kA);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = wt + 128 * j;
            const float4 v = ahi[e];
            float4 h, l;
            split_tf32(v.x, h.x, l.x);
            split_tf32(v.y, h.y, l.y);
            split_tf32(v.z, h.z, l.z);
            split_tf32(v.w, h.w, l.w);
            ahi[e] = h;
            alo[e] = l;
          }
          hop::fence_proxy_async();
          hop::named_barrier(1 + wg, 128);
        }
        // no access to acc between here and the wait below: the products
        // of consecutive stages chain into it while the previous ones run
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSpan / 32; ++kk) {  // a k step is 32 bytes
          const int restart = first && kk == 0 ? 0 : 1;
          const uint64_t dh = hop::make_desc(sa + 32 * kk, kSpan, 16, 8 * kSpan);
          const uint64_t dbh =
              hop::make_desc(sb + 32 * kk, kSpan, 16, 8 * kSpan);
          if constexpr (kP == 2) {
            const uint64_t dl =
                hop::make_desc(sa + T::kA + 32 * kk, kSpan, 16, 8 * kSpan);
            const uint64_t dbl =
                hop::make_desc(sb + T::kB + 32 * kk, kSpan, 16, 8 * kSpan);
            // the small terms first
            hop::WgmmaTf32<BN>::ss(acc, dl, dbh, restart);
            hop::WgmmaTf32<BN>::ss(acc, dh, dbl, 1);
            hop::WgmmaTf32<BN>::ss(acc, dh, dbh, 1);
          } else {
            hop::Wgmma<BN>::ss(acc, dh, dbh, restart);
          }
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // the previous stage's products are done
        if (it > 0 && lane == 0) hop::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (__any_sync(0xffffffffu,
                       (it + 1) % kFlush == 0 || it == iters - 1)) {
          hop::wgmma_wait<0>();
          hop::fence_regs(acc);
#pragma unroll
          for (int k = 0; k < BN / 2; ++k) sum[k] = __fadd_rn(sum[k], acc[k]);
        }
      }
      hop::wgmma_wait<0>();  // (done at the last flush; said for ptxas)
      if (iters > 0 && lane == 0) hop::mbar_arrive(&empty[prev]);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wg * 64 + w * 16 + g + 8 * h;
        if (m >= a.C) continue;
        E* orow = a.out + ((long long)b * a.C + m) * a.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (n < a.N)
            store2(orow + n, sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

template <class Op, int BN>
cudaError_t launch_tile(unsigned blocks, cudaStream_t stream,
                        const CUtensorMap& hi, const CUtensorMap& lo,
                        const K4Args<typename Op::E>& a) {
  return hop_host::launch_handover<&sparse_conv_kernel<Op, BN>>(
      K4Tile<Op, BN>::kSmem, blocks, kThreads, kLaunchRegs, stream, hi, lo,
      a);
}

// The entry points' common body: the checks, the tiles, the weight maps
// (the hi and lo of f32's [2, 27, N, K] pack; bf16's [27, N, K] pack, its
// one map passed twice) and the launch at N's tile.
template <class Op>
int launch_k4(const void* feats, const void* nbr, const void* w_pack,
              const void* poison, void* out, int B, int C, int K, int N,
              void* stream) {
  using E = typename Op::E;
  constexpr int kPiece = 16 / sizeof(E);
  if (B <= 0 || C <= 0 || K <= 0 || N <= 0 || K % kPiece || N % kPiece ||
      reinterpret_cast<uintptr_t>(feats) % 16 ||
      reinterpret_cast<uintptr_t>(w_pack) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = N <= 32 ? 32 : N <= 64 ? 64 : 128;
  K4Args<E> a;
  a.feats = static_cast<const E*>(feats);
  a.nbr = static_cast<const int*>(nbr);
  a.poison = static_cast<const int*>(poison);
  a.out = static_cast<E*>(out);
  a.C = C;
  a.K = K;
  a.N = N;
  a.m_tiles = (C + kRows - 1) / kRows;
  a.n_tiles = (N + bn - 1) / bn;
  a.kc = (K + kChunk<Op> - 1) / kChunk<Op>;
  const long long work = (long long)B * a.m_tiles * a.n_tiles;
  if (work >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  a.n_work = static_cast<int>(work);
  const int sms = hop_host::sm_count();
  const long long blocks = work < sms ? work : sms;
  const E* hi = static_cast<const E*>(w_pack);
  const E* lo = hi + (Op::kParts - 1) * (long long)kTaps * N * K;
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)kTaps * N};
  const uint64_t strides[1] = {(uint64_t)K * sizeof(E)};
  const uint32_t box[2] = {(uint32_t)kChunk<Op>, (uint32_t)bn};
  CUtensorMap thi, tlo;
  if (!hop_host::make_map(&thi, hi, 2, dims, strides, box, kSpan, Op::kMap) ||
      !hop_host::make_map(&tlo, lo, 2, dims, strides, box, kSpan, Op::kMap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaError_t e = bn == 32   ? launch_tile<Op, 32>(nb, st, thi, tlo, a)
                        : bn == 64 ? launch_tile<Op, 64>(nb, st, thi, tlo, a)
                                   : launch_tile<Op, 128>(nb, st, thi, tlo, a);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// feats f32 [B, C, K], nbr int32 [B, C, 27], w_pack f32 [2, 27, N, K] (the
// tf32 hi and lo of each tap's weights, transposed), poison int32 [B], out
// f32 [B, C, N]; K and N multiples of 4.
int sparse_conv_f32(const void* feats, const void* nbr, const void* w_pack,
                    const void* poison, void* out, int B, int C, int K, int N,
                    void* stream) {
  return launch_k4<Tf32x3>(feats, nbr, w_pack, poison, out, B, C, K, N,
                           stream);
}

// feats bf16 [B, C, K], nbr int32 [B, C, 27], w_pack bf16 [27, N, K] (each
// tap's weights, transposed), poison int32 [B], out bf16 [B, C, N]; K and N
// multiples of 8.
int sparse_conv_bf16(const void* feats, const void* nbr, const void* w_pack,
                     const void* poison, void* out, int B, int C, int K, int N,
                     void* stream) {
  return launch_k4<Bf16>(feats, nbr, w_pack, poison, out, B, C, K, N,
                         stream);
}

}  // extern "C"
