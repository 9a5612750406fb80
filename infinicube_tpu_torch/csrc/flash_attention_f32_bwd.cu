// Backward of the non-causal f32 flash attention for Hopper (sm_90a), behind
// a plain C interface (loaded with ctypes by infinicube_tpu_torch/kernels).
//
// flash_attn_f32_bwd replaces the fused backward of the library Pallas TPU
//   flash attention (jax.experimental.pallas.ops.tpu.flash_attention:
//   `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`, one
//   pallas_call each) for f32 inputs, which the gradient of
//   infinicube_tpu/ops/attention.py:25 `multi_head_attention` reaches on the
//   TPU in the inputs' dtype: the GSM pixel branch's SelfAttn2D when the GSM
//   trains (4 heads of 64 over 5,280 tokens a view at the release crop). It
//   is the backward of flash_attn_f32 (flash_attention_f32.cu): with
//   S = Q K^T * scale, P = exp(S - lse), D_i = sum_d O_i dO_i,
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//     dQ = dS K * scale,  dK = dS^T Q * scale,
//   f32 in and out, to f32 accuracy; keys >= Nk and queries >= Nq
//   contribute nothing, Nq != Nk allowed, head dim 64, 96 or 128. `lse` is
//   the natural log-sum-exp flash_attn_f32 stores (f32 [B, h, Nq]); `delta`
//   is D in the same layout, computed by the caller (as the library
//   computes its `di` outside the Pallas calls). The N^2 logits are
//   recomputed tile by tile and never reach device memory.
//
// What bounds it: 10*Nq*Nk*d f32 operations a (batch, head) (S, dP, dV, dK,
// dQ; the dQ pass recomputes S and dP, so 14 are done) against (4 inputs +
// 3 outputs)*N*d*4 bytes: operations. As three TF32 products at 495 TFLOP/s
// that is 1.30 ms at the GSM's train shape (3 views, N = 5,280, 4 heads of
// 64); as f32 work on the CUDA cores (67 TFLOP/s) about 3.2 ms. What
// holds this design back is data movement from L2: each 64-key item
// streams the tf32 hi and lo of Q and dO both as they lie and token-major
// (64 KB a 32-query tile), near L2's rate over the card; a 128-row item
// would halve that, but its hi and lo and the ring do not fit the shared
// memory together.
//
// Design: every product on wgmma m64nNk8 .f32.tf32.tf32 by the 3xTF32 split
// (a = hi + lo, hi the tf32 truncation of a, lo that of a - hi; lo_A hi_B +
// hi_A lo_B + hi_A hi_B, the small terms first), fed by TMA. A call runs:
// - a prologue kernel that writes, once a call, the tf32 hi and lo of Q, K,
//   V and dO as they lie ([2, B*h, N, d], d contiguous) and of Q, dO and K
//   token-major ([2, B*h, d, Np], Np = N rounded up to 8, zeros past N):
//   tf32 wgmma has no transpose bit, and three products sum over the
//   streamed rows (dV += P^T dO, dK += dS^T Q, dQ += dS K), so their B
//   operands must have the token axis contiguous. Within each 8 tokens the
//   token-major copies hold them in the order 0, 2, 4, 6, 1, 3, 5, 7, as
//   flash_attn_f32's Vt does: a thread's accumulators hold columns 2t and
//   2t+1 of each 8 where the tf32 A fragment wants t and t+4, so P and dS go
//   from the accumulators straight into the A operand, with no shuffle. No
//   warp splits a shared operand again.
// - two persistent kernels of one template, mirrored, like K5's: a dK/dV
//   pass and a dQ pass, so dQ takes no atomics:
//     item (64 rows, kept)         streamed tiles (the TMA ring)
//     dK/dV: K, V                   Q, dO (d-major); Q^T, dO^T (token-major)
//     dQ:    Q, dO                  K, V (d-major); K^T (token-major)
//   with BT = 32 streamed rows a tile at d = 64, 16 at 96 (and in the dQ
//   pass at 128), 8 in the dK/dV pass at 128. The item's hi and lo (1 KB a
//   column of d) and a ring of two to four stages share the 227 KB of
//   shared memory, so an item is 64 rows: both consumer warpgroups read it
//   (X = A1 B1^T and Y = A2 B2^T with both operands from shared memory) and
//   take the streamed tiles in turn, even and odd (each waits on barriers
//   of its own for them), each with sums of all 64 rows; at the end of an item the second hands its sums to the first
//   through the item's shared memory and they are added in that order. A
//   producer warpgroup gives its registers to the consumers (setmaxnreg, as
//   K2) and keeps the ring full; in the dK/dV pass one of its warps stages
//   each query tile's lse and D beside it.
// - Per tile a consumer warpgroup issues X and Y (S^T and dP^T, or S and
//   dP), turns them into P and dS in registers, splits them into tf32 A
//   fragments and issues the products over the tile's rows. The tensor
//   cores truncate every sum they accumulate, so each tile's products go
//   into sums of their own, 32 output columns at a time in two alternating
//   register sets (one is added into the f32 sums with a rounded add while
//   the next runs): the f32 sums never ride a chain of more than BT / 8 k8
//   steps, and 64 x 128 f32 sums for dK and dV fit beside them.
// - Where the items (B*h*ceil(N/64)) fall short of the SMs, the streamed
//   axis is split into fixed ranges of tiles: each (item, range) writes its
//   partial sums, and a combine pass adds the ranges in the order
//   s = 0 .. S-1 and scales. Two runs are bit-identical.
//
// Tensors are addressed by element strides (batch, token, head), 16-byte
// aligned. The entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for what it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kItemRows = 64;   // item rows, read by both consumers
constexpr int kThreads = 384;   // warpgroups 0, 1 consume, 2 produces
constexpr int kSmemMax = 232448;
// registers a thread after the hand-over: the producer warpgroup keeps 40,
// each consumer takes 232 (2 x 128 x 232 + 128 x 40 = 384 x 168, the pool of
// a 168-register launch)
constexpr int kProducerRegs = 40, kConsumerRegs = 232, kLaunchRegs = 168;

struct Strides {
  long long b, n, h;  // elements between batches, tokens, heads
};

__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

// the token at position p of its group of 8 in the token-major copies
// (order 0, 2, 4, 6, 1, 3, 5, 7)
__device__ __forceinline__ int token_at(int p) { return 2 * (p % 4) + p / 4; }

// streamed rows a tile: the item (1 KB a column of d) and two stages must
// fit the shared memory
__host__ __device__ constexpr int stream_tile(int d, bool dkv) {
  return d == 64 ? 32 : d == 96 || !dkv ? 16 : 8;
}

template <int D, bool kDKV>
struct BwdCfg {
  static constexpr int kBT = stream_tile(D, kDKV);   // streamed rows a tile
  static constexpr int kSpanT = kBT * 4;             // token-major row bytes
  static constexpr int kSlabItem = kItemRows * 128;  // 32 columns of d
  static constexpr int kItemPart = (D / 32) * kSlabItem;  // hi or lo
  static constexpr int kItem = 4 * kItemPart;        // A1 hi, lo, A2 hi, lo
  static constexpr int kSlabB = kBT * 128;
  static constexpr int kPartB = (D / 32) * kSlabB;   // a d-major tile part
  static constexpr int kPartT = D * kSpanT;          // a token-major part
  static constexpr int kNT = kDKV ? 2 : 1;           // token-major tensors
  static constexpr int kStage = 4 * kPartB + 2 * kNT * kPartT;
  static constexpr int kStats = kDKV ? 2 * kBT * 4 : 0;  // lse, D a stage
  static constexpr int kFree = kSmemMax - 1024 - kItem - 256;
  static constexpr int kFit = kFree / (kStage + kStats);
  static constexpr int kStages = kFit >= 4 ? 4 : kFit;
  static constexpr int kSmem =
      1024 + kItem + kStages * (kStage + kStats) + 8 * (2 + 3 * kStages);
  static_assert(kStages >= 1, "shared memory");
  static_assert(kPartB % 1024 == 0 && kPartT % 1024 == 0, "alignment");
};

struct PassArgs {
  const float* lse;    // [BH, nq], natural log
  const float* delta;  // [BH, nq]
  float* out1;         // dK or dQ (times sm_scale), one range
  float* out2;         // dV, or null
  Strides so1, so2;
  float* part1;        // [S, BH, n_item, D] partial sums, more than one range
  float* part2;
  int H, BH, nq, nk, item_tiles, splits, per_split, n_items;
  float sm_scale;
};

// K, V (dK/dV) or Q, dO (dQ) hi and lo rows of the item: maps ta1, ta2 (boxes
// of 32 columns x 64 rows of the [2, BH, n, D] packs); Q, dO or K, V of a
// tile: tb1, tb2 (32 x BT); Q^T, dO^T or K^T: tt1, tt2 (BT x D of the
// [2, BH, D, Np] packs).
template <int D, bool kDKV>
__global__ void __launch_bounds__(kThreads, 1)
    f32_bwd_kernel(const __grid_constant__ CUtensorMap ta1,
                   const __grid_constant__ CUtensorMap ta2,
                   const __grid_constant__ CUtensorMap tb1,
                   const __grid_constant__ CUtensorMap tb2,
                   const __grid_constant__ CUtensorMap tt1,
                   const __grid_constant__ CUtensorMap tt2,
                   const PassArgs a) {
  using C = BwdCfg<D, kDKV>;
  constexpr int BT = C::kBT, SPAN = C::kSpanT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* item = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = item + C::kItem;
  float* stats = reinterpret_cast<float*>(ring + C::kStages * C::kStage);
  uint64_t* it_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(stats) + C::kStages * C::kStats);
  uint64_t* it_empty = it_full + 1;
  // tile n goes to stage n % kStages and to consumer n % 2, which waits on
  // full[n % 2][stage]: the uses of each such barrier are the tiles of one
  // consumer, in order, so none waits past a phase it did not see
  uint64_t* full = it_full + 2;  // [2][kStages]
  uint64_t* empty = full + 2 * C::kStages;
  constexpr int kCycle = C::kStages % 2 ? 2 * C::kStages : C::kStages;

  const int n_item = kDKV ? a.nk : a.nq, n_str = kDKV ? a.nq : a.nk;
  const int n_tiles = (n_str + BT - 1) / BT;
  if (threadIdx.x == 0) {
    hop::mbar_init(it_full, 1);
    hop::mbar_init(it_empty, 4);  // lane 0 of the first consumer's warps
    for (int s = 0; s < C::kStages; ++s) {
      // the TMA thread, and in the dK/dV pass the 32 lanes that stage lse, D
      hop::mbar_init(&full[s], kDKV ? 33 : 1);
      hop::mbar_init(&full[C::kStages + s], kDKV ? 33 : 1);
      hop::mbar_init(&empty[s], 4);  // lane 0 of the consuming warpgroup's
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: per item its rows, then its tiles through the ring ----
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&ta1);
      hop::prefetch_map(&ta2);
      hop::prefetch_map(&tb1);
      hop::prefetch_map(&tb2);
      hop::prefetch_map(&tt1);
      if constexpr (kDKV) hop::prefetch_map(&tt2);
      uint32_t it_phase = 0;
      int n = 0;  // tiles issued so far: stage n % kStages
      for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
        const int sp = it % a.splits, rest = it / a.splits;
        const int bh = rest / a.item_tiles;
        const int r0 = rest % a.item_tiles * kItemRows;
        const int t0 = sp * a.per_split;
        const int t1 = min(n_tiles, t0 + a.per_split);
        hop::mbar_wait(it_empty, it_phase ^ 1);
        it_phase ^= 1;
        hop::mbar_expect_tx(it_full, C::kItem);
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
          uint8_t* s = item + j * C::kSlabItem;
          hop::tma_load_3d(s, &ta1, it_full, 32 * j, r0, bh);
          hop::tma_load_3d(s + C::kItemPart, &ta1, it_full, 32 * j, r0,
                           a.BH + bh);
          hop::tma_load_3d(s + 2 * C::kItemPart, &ta2, it_full, 32 * j, r0,
                           bh);
          hop::tma_load_3d(s + 3 * C::kItemPart, &ta2, it_full, 32 * j, r0,
                           a.BH + bh);
        }
        for (int t = t0; t < t1; ++t, ++n) {
          const int stage = n % C::kStages;
          hop::mbar_wait(&empty[stage], ((n / C::kStages) & 1) ^ 1);
          uint8_t* st = ring + stage * C::kStage;
          uint64_t* bar = &full[(n & 1) * C::kStages + stage];
          hop::mbar_expect_tx(bar, C::kStage);
#pragma unroll
          for (int j = 0; j < D / 32; ++j) {
            uint8_t* s = st + j * C::kSlabB;
            hop::tma_load_3d(s, &tb1, bar, 32 * j, t * BT, bh);
            hop::tma_load_3d(s + C::kPartB, &tb1, bar, 32 * j, t * BT,
                             a.BH + bh);
            hop::tma_load_3d(s + 2 * C::kPartB, &tb2, bar, 32 * j, t * BT,
                             bh);
            hop::tma_load_3d(s + 3 * C::kPartB, &tb2, bar, 32 * j, t * BT,
                             a.BH + bh);
          }
          uint8_t* s = st + 4 * C::kPartB;
          hop::tma_load_3d(s, &tt1, bar, t * BT, 0, bh);
          hop::tma_load_3d(s + C::kPartT, &tt1, bar, t * BT, 0, a.BH + bh);
          if constexpr (kDKV) {
            hop::tma_load_3d(s + 2 * C::kPartT, &tt2, bar, t * BT, 0, bh);
            hop::tma_load_3d(s + 3 * C::kPartT, &tt2, bar, t * BT, 0,
                             a.BH + bh);
          }
        }
      }
    } else if (kDKV && threadIdx.x / 32 == 9) {
      // lse (base 2) and D of each query tile into its stage's stats;
      // queries >= nq as lse = +inf, D = 0, so their P and dS are 0
      const int lane = threadIdx.x % 32;
      int n = 0;
      for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
        const int sp = it % a.splits, bh = it / a.splits / a.item_tiles;
        const float* lse_row = a.lse + (long long)bh * a.nq;
        const float* d_row = a.delta + (long long)bh * a.nq;
        const int t0 = sp * a.per_split;
        const int t1 = min(n_tiles, t0 + a.per_split);
        for (int t = t0; t < t1; ++t, ++n) {
          const int stage = n % C::kStages;
          hop::mbar_wait(&empty[stage], ((n / C::kStages) & 1) ^ 1);
          float* st = stats + stage * 2 * BT;
          for (int i = lane; i < BT; i += 32) {
            const int r = t * BT + i;
            st[i] = r < a.nq ? lse_row[r] * kLog2e
                             : __int_as_float(0x7f800000);
            st[BT + i] = r < a.nq ? d_row[r] : 0.f;
          }
          hop::mbar_arrive(&full[(n & 1) * C::kStages + stage]);
        }
      }
    }
  } else {
    // ---- consumers: both read the item's 64 rows; tiles in turn ----
    hop::setmaxnreg_inc<kConsumerRegs>();
    const int wt = threadIdx.x % 128, lane = threadIdx.x % 32, w = wt / 32;
    const int g = lane / 4, q = lane % 4;
    const float scale_log2 = a.sm_scale * kLog2e;
    float sum1[D / 2];               // dK or dQ
    float sum2[kDKV ? D / 2 : 1];    // dV
    float x[BT / 2], y[BT / 2];      // S^T and dP^T, or S and dP
    uint32_t ph[BT / 8][4], pl[BT / 8][4];  // P^T's A fragments (dK/dV)
    uint32_t sh[BT / 8][4], sl[BT / 8][4];  // dS's (or dS^T's)
    float f0[16], f1[16];            // one tile's products, 32 columns
    uint32_t it_phase = 0;
    int n = 0;
    for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
      const int sp = it % a.splits, rest = it / a.splits;
      const int bh = rest / a.item_tiles, b = bh / a.H, h = bh % a.H;
      const int ra = rest % a.item_tiles * kItemRows + w * 16 + g;
      const int rb = ra + 8;
      const int t0 = sp * a.per_split;
      const int t1 = min(n_tiles, t0 + a.per_split);
      // dQ: the rows' lse (base 2) and D; rows >= nq get lse = +inf, D = 0
      float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
      if constexpr (!kDKV) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? rb : ra;
          const bool ok = row < a.nq;
          lse2[r] = ok ? a.lse[(long long)bh * a.nq + row] * kLog2e
                       : __int_as_float(0x7f800000);
          dl[r] = ok ? a.delta[(long long)bh * a.nq + row] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) sum1[i] = 0.f;
      if constexpr (kDKV) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) sum2[i] = 0.f;
      }
      hop::mbar_wait(it_full, it_phase);
      it_phase ^= 1;

      for (int t = t0; t < t1; ++t, ++n) {
        if ((n & 1) != wg) continue;  // the other warpgroup's tile
        const int stage = n % C::kStages;
        hop::mbar_wait(&full[wg * C::kStages + stage], (n / kCycle) & 1);
        const uint8_t* st = ring + stage * C::kStage;

        // X = A1 B1^T, Y = A2 B2^T: both K-major on d, 32 columns (128
        // bytes) a row of each slab
        auto issue_xy = [&](float(&o)[BT / 2], const uint8_t* ia,
                            const uint8_t* tb) {
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 8; ++kk) {
            const uint8_t* ah = ia + kk / 4 * C::kSlabItem + kk % 4 * 32;
            const uint8_t* bh_ = tb + kk / 4 * C::kSlabB + kk % 4 * 32;
            const uint64_t dah = hop::make_desc(ah, 128, 16, 1024);
            const uint64_t dal = hop::make_desc(ah + C::kItemPart, 128, 16,
                                                1024);
            const uint64_t dbh = hop::make_desc(bh_, 128, 16, 1024);
            const uint64_t dbl = hop::make_desc(bh_ + C::kPartB, 128, 16,
                                                1024);
            hop::WgmmaTf32<BT>::ss(o, dal, dbh, kk > 0);
            hop::WgmmaTf32<BT>::ss(o, dah, dbl, 1);
            hop::WgmmaTf32<BT>::ss(o, dah, dbh, 1);
          }
          hop::wgmma_commit();
        };
        issue_xy(x, item, st);
        issue_xy(y, item + 2 * C::kItemPart, st + 2 * C::kPartB);
        hop::wgmma_wait<1>();
        hop::fence_regs(x);
        // P; columns t BT + 8 j + 2 q + (e & 1), rows ra (e < 2), rb
        const float* sts = stats + stage * 2 * BT;
        const int valid = n_str - t * BT;
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * q + (e & 1);
            if constexpr (kDKV)
              x[4 * j + e] = exp2f(x[4 * j + e] * scale_log2 - sts[col]);
            else
              x[4 * j + e] = col < valid ? exp2f(x[4 * j + e] * scale_log2 -
                                                 lse2[e >> 1])
                                         : 0.f;
          }
        }
        hop::wgmma_wait<0>();
        hop::fence_regs(y);
        // dS, and both as tf32 A fragments: a[r] is (row g + 8 (r % 2),
        // position q + 4 (r / 2)), the token 2 q + r / 2 of each 8
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = (r % 2) * 2 + r / 2;
            const int col = 8 * j + 2 * q + (e & 1);
            const float dd = kDKV ? sts[BT + col] : dl[e >> 1];
            const float p = x[4 * j + e];
            const float ds = p * (y[4 * j + e] - dd);
            const float dh = tf32_trunc(ds);
            sh[j][r] = __float_as_uint(dh);
            sl[j][r] = __float_as_uint(tf32_trunc(ds - dh));
            if constexpr (kDKV) {
              const float hi = tf32_trunc(p);
              ph[j][r] = __float_as_uint(hi);
              pl[j][r] = __float_as_uint(tf32_trunc(p - hi));
            }
          }
        }

        // acc[32 c ..] += Z T over the tile's rows: Z's fragments (P^T or
        // dS) against a token-major tile part (its rows the output's
        // columns), one chunk of 32 columns into f
        const uint8_t* tt = st + 4 * C::kPartB;
        auto issue_chunk = [&](float(&f)[16], const uint32_t(&zh)[BT / 8][4],
                               const uint32_t(&zl)[BT / 8][4],
                               const uint8_t* part, int c) {
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BT / 8; ++kk) {
            const uint8_t* p = part + 32 * c * SPAN + 32 * kk;
            const uint64_t dh = hop::make_desc(p, SPAN, 16, 8 * SPAN);
            const uint64_t dlo =
                hop::make_desc(p + C::kPartT, SPAN, 16, 8 * SPAN);
            hop::WgmmaTf32<32>::rs(f, zl[kk], dh, kk > 0);
            hop::WgmmaTf32<32>::rs(f, zh[kk], dlo, 1);
            hop::WgmmaTf32<32>::rs(f, zh[kk], dh, 1);
          }
          hop::wgmma_commit();
        };
        // chunk i: dV (P^T against dO^T) for i < D / 32, then dK (dS^T
        // against Q^T); the dQ pass has dQ (dS against K^T) alone
        constexpr int kC = D / 32, kNC = kDKV ? 2 * kC : kC;
        auto issue = [&](float(&f)[16], int i) {
          if (kDKV && i < kC)
            issue_chunk(f, ph, pl, tt + 2 * C::kPartT, i);
          else
            issue_chunk(f, sh, sl, tt, i % kC);
        };
        auto add = [&](const float(&f)[16], int i) {
          float* s = kDKV && i < kC ? sum2 : sum1;
#pragma unroll
          for (int k = 0; k < 16; ++k)
            s[16 * (i % kC) + k] = __fadd_rn(s[16 * (i % kC) + k], f[k]);
        };
        issue(f0, 0);
#pragma unroll
        for (int i = 0; i < kNC; i += 2) {
          if (i + 1 < kNC) {
            issue(f1, i + 1);
            hop::wgmma_wait<1>();
          } else {
            hop::wgmma_wait<0>();
          }
          hop::fence_regs(f0);
          add(f0, i);
          if (i + 1 < kNC) {
            if (i + 2 < kNC) {
              issue(f0, i + 2);
              hop::wgmma_wait<1>();
            } else {
              hop::wgmma_wait<0>();
            }
            hop::fence_regs(f1);
            add(f1, i + 1);
          }
        }
        hop::fence_regs(sh);
        hop::fence_regs(sl);
        if constexpr (kDKV) {
          hop::fence_regs(ph);
          hop::fence_regs(pl);
        }
        if (lane == 0) hop::mbar_arrive(&empty[stage]);
      }

      // ---- the item's sums: the second warpgroup's added into the first's
      // through the item's shared memory, then stored ----
      hop::named_barrier(1, 256);  // both are done reading the item
      float* xs = reinterpret_cast<float*>(item);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) xs[i * 128 + wt] = sum1[i];
        if constexpr (kDKV) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) xs[(D / 2 + i) * 128 + wt] = sum2[i];
        }
        hop::fence_proxy_async();  // the next item's TMA overwrites them
      }
      hop::named_barrier(1, 256);
      if (wg == 1) continue;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        sum1[i] = __fadd_rn(sum1[i], xs[i * 128 + wt]);
      if constexpr (kDKV) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i)
          sum2[i] = __fadd_rn(sum2[i], xs[(D / 2 + i) * 128 + wt]);
      }
      hop::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(it_empty);

      // rows < n_item: scaled into the outputs, or this range's partials
      const bool ok[2] = {ra < n_item, rb < n_item};
#pragma unroll
      for (int o = 0; o < (kDKV ? 2 : 1); ++o) {
        const float* s = o ? sum2 : sum1;
        const float f = o ? 1.f : a.sm_scale;
        float* base[2];
        if (a.splits == 1) {
          float* ob = (o ? a.out2 : a.out1) +
                      b * (o ? a.so2 : a.so1).b + h * (o ? a.so2 : a.so1).h;
          const long long sn = (o ? a.so2 : a.so1).n;
          base[0] = ob + ra * sn;
          base[1] = ob + rb * sn;
        } else {
          float* pb = (o ? a.part2 : a.part1) +
                      ((long long)sp * a.BH + bh) * n_item * D;
          base[0] = pb + (long long)ra * D;
          base[1] = pb + (long long)rb * D;
        }
        const float m = a.splits == 1 ? f : 1.f;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int c = 8 * j + 2 * q;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (ok[r])
              *reinterpret_cast<float2*>(base[r] + c) =
                  make_float2(s[4 * j + 2 * r] * m, s[4 * j + 2 * r + 1] * m);
        }
      }
    }
  }
}

// x [B, n, H, D] (strided) -> dm [2, BH, n, D] (tf32 hi, lo) and, where tm
// is given, tm [2, BH, D, np] (hi, lo; tokens in the order of token_at
// within each 8, zeros past n). One block a (32 tokens, batch*head).
template <int D>
__global__ void __launch_bounds__(256)
    f32_bwd_prep_kernel(const float* __restrict__ x, Strides sx,
                        float* __restrict__ dm, float* __restrict__ tm, int H,
                        int n, int np) {
  __shared__ float tile[32][D + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long BH = gridDim.y;
  const int r0 = blockIdx.x * 32;
  for (int i = threadIdx.x; i < 32 * D / 4; i += blockDim.x) {
    const int r = i / (D / 4), c = i % (D / 4) * 4;
    const int tok = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tok < n) {
      v = *reinterpret_cast<const float4*>(x + b * sx.b + tok * sx.n +
                                           h * sx.h + c);
      float4 hi, lo;
      hi.x = tf32_trunc(v.x);
      hi.y = tf32_trunc(v.y);
      hi.z = tf32_trunc(v.z);
      hi.w = tf32_trunc(v.w);
      lo.x = tf32_trunc(v.x - hi.x);
      lo.y = tf32_trunc(v.y - hi.y);
      lo.z = tf32_trunc(v.z - hi.z);
      lo.w = tf32_trunc(v.w - hi.w);
      *reinterpret_cast<float4*>(dm + ((long long)bh * n + tok) * D + c) = hi;
      *reinterpret_cast<float4*>(dm + ((BH + bh) * n + tok) * D + c) = lo;
    }
    tile[r][c] = v.x;
    tile[r][c + 1] = v.y;
    tile[r][c + 2] = v.z;
    tile[r][c + 3] = v.w;
  }
  if (tm == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * D; i += blockDim.x) {
    const int c = i / 32, p = i % 32;
    if (r0 + p >= np) continue;
    const float val = tile[p / 8 * 8 + token_at(p % 8)][c];
    const float hi = tf32_trunc(val);
    tm[((long long)bh * D + c) * np + r0 + p] = hi;
    tm[((BH + bh) * D + c) * np + r0 + p] = tf32_trunc(val - hi);
  }
}

// out[b, r, h, :] = scale * sum_s part[s, bh, r, :], in order s = 0 .. S-1;
// four columns a thread
template <int D>
__global__ void __launch_bounds__(256)
    f32_bwd_combine_kernel(const float* __restrict__ part,
                           float* __restrict__ out, Strides so, int H, int n,
                           int splits, long long rows, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * (D / 4)) return;
  const long long row = i / (D / 4);  // bh * n + r
  const int c = static_cast<int>(i % (D / 4)) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 p =
        *reinterpret_cast<const float4*>(part + (s * rows + row) * D + c);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const int bh = static_cast<int>(row / n), r = static_cast<int>(row % n);
  *reinterpret_cast<float4*>(out + bh / H * so.b + r * so.n + bh % H * so.h +
                             c) =
      make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The streamed axis's ranges of one pass: S and the tiles a range. One
// range while the items (batch*head x 64-row item tiles) fill the SMs;
// else as many as fit in one wave, at most one a tile and 16.
void plan_pass(int BH, int n_item, int n_str, int d, bool dkv, int sms,
               int* splits, int* per_split) {
  const long long items =
      (long long)BH * ((n_item + kItemRows - 1) / kItemRows);
  const int bt = stream_tile(d, dkv);
  const int n_tiles = (n_str + bt - 1) / bt;
  long long s = items >= sms ? 1 : sms / items;
  s = s < 16 ? s : 16;
  s = s < n_tiles ? s : n_tiles;
  *per_split = (n_tiles + static_cast<int>(s) - 1) / static_cast<int>(s);
  *splits = (n_tiles + *per_split - 1) / *per_split;  // none left empty
}

struct Packs {  // the prologue's copies, in one scratch buffer
  float *qd, *kd, *vd, *dod, *qt, *dot, *kt;
};

Packs carve(float* p, int BH, int nq, int nk, int d) {
  const long long q = 2LL * BH * nq * d, k = 2LL * BH * nk * d;
  const long long qt = 2LL * BH * d * round_up(nq, 8);
  Packs s;
  s.qd = p;
  s.kd = s.qd + q;
  s.vd = s.kd + k;
  s.dod = s.vd + k;
  s.qt = s.dod + q;
  s.dot = s.qt + qt;
  s.kt = s.dot + qt;
  return s;
}

// a [2, BH, n, D] pack in boxes of 32 columns x `rows`
bool dmajor_map(CUtensorMap* m, const float* p, int BH, int n, int d,
                int rows) {
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)n, (uint64_t)2 * BH};
  const uint64_t st[2] = {(uint64_t)d * 4, (uint64_t)n * d * 4};
  const uint32_t box[3] = {32, (uint32_t)rows, 1};
  return hop_host::make_map(m, p, 3, dims, st, box, 128,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// a [2, BH, D, np] pack in boxes of BT tokens x D
bool tmajor_map(CUtensorMap* m, const float* p, int BH, int np, int d,
                int bt) {
  const uint64_t dims[3] = {(uint64_t)np, (uint64_t)d, (uint64_t)2 * BH};
  const uint64_t st[2] = {(uint64_t)np * 4, (uint64_t)d * np * 4};
  const uint32_t box[3] = {(uint32_t)bt, (uint32_t)d, 1};
  return hop_host::make_map(m, p, 3, dims, st, box, bt * 4,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <int D>
cudaError_t prep(cudaStream_t st, const float* x, Strides sx, float* dm,
                 float* tm, int BH, int H, int n) {
  const int np = round_up(n, 8);
  f32_bwd_prep_kernel<D><<<dim3((np + 31) / 32, BH), 256, 0, st>>>(
      x, sx, dm, tm, H, n, np);
  return cudaGetLastError();
}

template <int D>
cudaError_t combine(cudaStream_t st, const float* part, float* out,
                    Strides so, int BH, int H, int n, int splits,
                    float scale) {
  const long long rows = (long long)BH * n;
  const long long threads = rows * (D / 4);
  f32_bwd_combine_kernel<D>
      <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
          part, out, so, H, n, splits, rows, scale);
  return cudaGetLastError();
}

template <int D, bool kDKV>
cudaError_t launch_pass(cudaStream_t st, const CUtensorMap (&m)[6],
                        PassArgs a, int sms) {
  using C = BwdCfg<D, kDKV>;
  const long long items = (long long)a.item_tiles * a.BH * a.splits;
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  a.n_items = static_cast<int>(items);
  const unsigned blocks = a.n_items < sms ? a.n_items : sms;
  return hop_host::launch_handover<&f32_bwd_kernel<D, kDKV>>(
      C::kSmem, blocks, kThreads, kLaunchRegs, st, m[0], m[1], m[2], m[3],
      m[4], m[5], a);
}

template <int D>
cudaError_t launch_bwd(cudaStream_t st, const float* q, const float* k,
                       const float* v, const float* dout, const float* lse,
                       const float* delta, float* dq, float* dk, float* dv,
                       float* scratch, float* part, int B, int H, int nq,
                       int nk, int sms, Strides sq, Strides sk, Strides sv,
                       Strides sdo, Strides sdq, Strides sdk, Strides sdv,
                       float sm_scale) {
  constexpr int BTK = stream_tile(D, true), BTQ = stream_tile(D, false);
  const int BH = B * H, nqp = round_up(nq, 8), nkp = round_up(nk, 8);
  const Packs p = carve(scratch, BH, nq, nk, D);
  cudaError_t e;
  if ((e = prep<D>(st, q, sq, p.qd, p.qt, BH, H, nq)) != cudaSuccess ||
      (e = prep<D>(st, k, sk, p.kd, p.kt, BH, H, nk)) != cudaSuccess ||
      (e = prep<D>(st, v, sv, p.vd, nullptr, BH, H, nk)) != cudaSuccess ||
      (e = prep<D>(st, dout, sdo, p.dod, p.dot, BH, H, nq)) != cudaSuccess)
    return e;
  CUtensorMap kv[6], qm[6];
  if (!dmajor_map(&kv[0], p.kd, BH, nk, D, kItemRows) ||
      !dmajor_map(&kv[1], p.vd, BH, nk, D, kItemRows) ||
      !dmajor_map(&kv[2], p.qd, BH, nq, D, BTK) ||
      !dmajor_map(&kv[3], p.dod, BH, nq, D, BTK) ||
      !tmajor_map(&kv[4], p.qt, BH, nqp, D, BTK) ||
      !tmajor_map(&kv[5], p.dot, BH, nqp, D, BTK) ||
      !dmajor_map(&qm[0], p.qd, BH, nq, D, kItemRows) ||
      !dmajor_map(&qm[1], p.dod, BH, nq, D, kItemRows) ||
      !dmajor_map(&qm[2], p.kd, BH, nk, D, BTQ) ||
      !dmajor_map(&qm[3], p.vd, BH, nk, D, BTQ) ||
      !tmajor_map(&qm[4], p.kt, BH, nkp, D, BTQ))
    return cudaErrorInvalidValue;
  qm[5] = qm[4];
  PassArgs a;
  a.lse = lse;
  a.delta = delta;
  a.H = H;
  a.BH = BH;
  a.nq = nq;
  a.nk = nk;
  a.sm_scale = sm_scale;
  // dK, dV: the keys are the item rows
  plan_pass(BH, nk, nq, D, true, sms, &a.splits, &a.per_split);
  const int s_kv = a.splits;
  a.item_tiles = (nk + kItemRows - 1) / kItemRows;
  a.out1 = dk;
  a.so1 = sdk;
  a.out2 = dv;
  a.so2 = sdv;
  a.part1 = part;
  a.part2 = s_kv > 1 ? part + (long long)s_kv * BH * nk * D : nullptr;
  if ((e = launch_pass<D, true>(st, kv, a, sms)) != cudaSuccess) return e;
  if (s_kv > 1 &&
      ((e = combine<D>(st, a.part1, dk, sdk, BH, H, nk, s_kv, sm_scale)) !=
           cudaSuccess ||
       (e = combine<D>(st, a.part2, dv, sdv, BH, H, nk, s_kv, 1.f)) !=
           cudaSuccess))
    return e;
  // dQ: the queries are
  plan_pass(BH, nq, nk, D, false, sms, &a.splits, &a.per_split);
  const int s_q = a.splits;
  a.item_tiles = (nq + kItemRows - 1) / kItemRows;
  a.out1 = dq;
  a.so1 = sdq;
  a.out2 = nullptr;
  a.so2 = sdq;
  a.part1 = s_kv > 1 ? part + 2LL * s_kv * BH * nk * D : part;
  a.part2 = nullptr;
  if ((e = launch_pass<D, false>(st, qm, a, sms)) != cudaSuccess) return e;
  if (s_q > 1)
    return combine<D>(st, a.part1, dq, sdq, BH, H, nq, s_q, sm_scale);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The streamed axis's ranges of flash_attn_f32_bwd's dK/dV pass (dkv != 0)
// or its dQ pass on a card with `sms` SMs (1: none).
int flash_attn_f32_bwd_splits(int B, int H, int nq, int nk, int d, int sms,
                              int dkv) {
  int splits, per_split;
  if (dkv)
    plan_pass(B * H, nk, nq, d, true, sms, &splits, &per_split);
  else
    plan_pass(B * H, nq, nk, d, false, sms, &splits, &per_split);
  return splits;
}

// q, dout, dq: f32 [B, nq, H, d]; k, v, dk, dv: f32 [B, nk, H, d], by
// element strides (batch, token, head), 16-byte aligned; lse, delta:
// contiguous f32 [B, H, nq]. Scratch from the caller: `scratch` f32 for the
// prologue's copies, 2 B H d (4 nq + 3 nk) + 2 B H d (2 nq' + nk') floats
// (n' = n rounded up to 8), and `part` f32 for the partial sums of the
// passes that take more than one range (flash_attn_f32_bwd_splits): S_kv *
// 2 * B H nk d, then S_q * B H nq d, or null where neither does.
int flash_attn_f32_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, void* scratch,
                       void* part, int B, int H, int nq, int nk, int d,
                       int sms, long long q_sb, long long q_sn, long long q_sh,
                       long long k_sb, long long k_sn, long long k_sh,
                       long long v_sb, long long v_sn, long long v_sh,
                       long long do_sb, long long do_sn, long long do_sh,
                       long long dq_sb, long long dq_sn, long long dq_sh,
                       long long dk_sb, long long dk_sn, long long dk_sh,
                       long long dv_sb, long long dv_sn, long long dv_sh,
                       float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || nq <= 0 || nk <= 0 || sms <= 0 ||
      (long long)B * H > 65535 || (d != 64 && d != 96 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool need_part =
      flash_attn_f32_bwd_splits(B, H, nq, nk, d, sms, 1) > 1 ||
      flash_attn_f32_bwd_splits(B, H, nq, nk, d, sms, 0) > 1;
  if (need_part != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, sdo{do_sb, do_sn, do_sh}, sdq{dq_sb, dq_sn, dq_sh},
      sdk{dk_sb, dk_sn, dk_sh}, sdv{dv_sb, dv_sn, dv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto dop = static_cast<const float*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto dlp = static_cast<const float*>(delta);
  auto dqp = static_cast<float*>(dq);
  auto dkp = static_cast<float*>(dk);
  auto dvp = static_cast<float*>(dv);
  auto sp = static_cast<float*>(scratch);
  auto pp = static_cast<float*>(part);
  cudaError_t e;
  if (d == 128)
    e = launch_bwd<128>(st, qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, sp, pp,
                        B, H, nq, nk, sms, sq, sk, sv, sdo, sdq, sdk, sdv,
                        sm_scale);
  else if (d == 96)
    e = launch_bwd<96>(st, qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, sp, pp,
                       B, H, nq, nk, sms, sq, sk, sv, sdo, sdq, sdk, sdv,
                       sm_scale);
  else
    e = launch_bwd<64>(st, qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, sp, pp,
                       B, H, nq, nk, sms, sq, sk, sv, sdo, sdq, sdk, sdv,
                       sm_scale);
  return static_cast<int>(e);
}

}  // extern "C"
