// Backward of the non-causal bf16 flash attention for Hopper (sm_90a),
// behind a plain C interface (loaded with ctypes by
// infinicube_tpu_torch/kernels).
//
// flash_attn_bf16_bwd (K5) replaces the fused backward of the library Pallas
//   TPU flash attention (jax.experimental.pallas.ops.tpu.flash_attention:
//   `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`, one
//   pallas_call each) that the gradient of
//   infinicube_tpu/ops/attention.py:25 `multi_head_attention` reaches on the
//   TPU. It is the backward of flash_attn_bf16 (K2, flash_attention.cu):
//   with S = Q K^T * scale, P = exp(S - lse), D_i = sum_d O_i dO_i,
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//     dQ = dS K * scale,  dK = dS^T Q * scale,
//   bf16 in and out, f32 accumulation, keys >= Nk and rows >= Nq contribute
//   nothing, Nq != Nk allowed, head dim 64, 96 or 128. `lse` is the natural
//   log-sum-exp K2 stores (f32 [B, h, Nq]); `delta` is D in the same layout,
//   computed by the caller (as the library computes its `di` outside the
//   Pallas calls). The N^2 logits are recomputed tile by tile and never
//   reach device memory. It runs the 10 SelfAttention3D backwards of one
//   training step of the voxel UNet (d = 96, N = 4,096 and 512).
//
// What bounds it: 10*Nq*Nk*d operations per (batch, head) (S, dP, dV, dK, dQ;
// the dQ pass recomputes S and dP, so 14 are done) against
// (3 inputs + dO + 3 outputs)*N*d*2 bytes: tensor-core bound.
//
// Design (on wgmma and TMA, after K2): two kernels like the library's, the
// dK/dV one and then the dQ one, so no atomics and a result that is
// bit-identical from run to run. They are one template, mirrored:
//   item tile (loaded once an item)   streamed tiles (the TMA ring)
//   dK/dV: 128 keys of K and V         64 queries of Q and dO, with their
//                                      lse and D
//   dQ:    128 queries of Q and dO     64 keys of K and V
// Persistent blocks, one per SM, walk the items (batch*head, 128 rows); two
// consumer warpgroups own 64 item rows each, and a producer warpgroup hands
// them its registers (setmaxnreg: 240 each, 24 left) and keeps the 3-stage
// ring full by TMA from tensor maps built on the views' strides, as K2's.
// For each streamed tile a consumer warpgroup
// - computes X = A1 B1^T and Y = A2 B2^T with wgmma m64n64k16, both operands
//   K-major on d in shared memory (A = the item rows, B = the tile's rows):
//   S (dQ) or S^T (dK/dV), and dP or dP^T;
// - turns them into P = exp2(S scale log2 e - lse log2 e) and dS = P o
//   (dP - D) in registers, masking keys >= Nk and queries >= Nq to exactly
//   0 (the dQ pass keeps its rows' lse and D in registers; the dK/dV pass
//   reads its columns' from shared memory, where the producer warpgroup's
//   second warp stages them beside each tile with plain loads, queries >= Nq
//   as lse = +inf, D = 0: no TMA zero fill is relied on);
// - packs them to bf16 as the A operands of wgmma m64n{d}k16 whose B operand
//   is the streamed tile read d-major through the transpose bit:
//   dQ += dS K, or dV += P^T dO and dK += dS^T Q.
// Tiles are 32-column slabs under the 64-byte swizzle, as in K2, so d = 96
// (192-byte rows) takes the same path as 64 and 128. The streamed tile is 64
// rows, not 128: the dK/dV warpgroups hold two 64 x d f32 accumulators (128
// registers a thread at d = 128) beside X and Y.
//
// Tensors are addressed by element strides (batch, token, head) as in K2.
// The entry point returns cudaGetLastError().

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kItemRows = 128;  // item rows a block, 64 per consumer
constexpr int kTile = 64;       // rows of a streamed tile
constexpr int kStages = 3;
constexpr int kSlab = 32;       // columns of a slab: 64 bytes, 64-byte swizzle
// as K2: 2 x 128 x 240 + 128 x 24 = 384 x 168, a 168-register launch's pool
constexpr int kProducerRegs = 24, kConsumerRegs = 240, kLaunchRegs = 168;

template <int D>
struct BwdSmem {
  static constexpr int kThreads = 384;
  static constexpr int kSlabItem = kItemRows * kSlab * 2;
  static constexpr int kSlabTile = kTile * kSlab * 2;
  static constexpr int kItem = (D / kSlab) * kSlabItem;  // one item tensor
  static constexpr int kTileB = (D / kSlab) * kSlabTile;  // one tile tensor
  static constexpr int kStage = 2 * kTileB;
  static constexpr int kStats = kStages * 2 * kTile * 4;  // lse, D a stage
  static constexpr int kSmem = 2 * kItem + kStages * kStage + kStats + 1024 +
                               64;
};

// kDKV: the dK/dV pass (item = keys, tiles = queries); otherwise the dQ pass
// (item = queries, tiles = keys). Maps: a1, a2 the item tensors (K, V or Q,
// dO) in boxes of 128 rows; b1, b2 the streamed ones (Q, dO or K, V) in
// boxes of 64. out1 gets dK or dQ (times sm_scale), out2 dV.
template <int D, bool kDKV>
__global__ void __launch_bounds__(BwdSmem<D>::kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tma1,
                     const __grid_constant__ CUtensorMap tma2,
                     const __grid_constant__ CUtensorMap tmb1,
                     const __grid_constant__ CUtensorMap tmb2,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ out1,
                     __nv_bfloat16* __restrict__ out2, Strides so1,
                     Strides so2, int H, int nq, int nk, int item_tiles,
                     int n_items, float sm_scale) {
  using S = BwdSmem<D>;
  constexpr int kSlabs = D / kSlab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = sa + 2 * S::kItem;
  float* stats = reinterpret_cast<float*>(ring + kStages * S::kStage);
  uint64_t* it_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(stats) + S::kStats);
  uint64_t* it_empty = it_full + 1;
  uint64_t* full = it_full + 2;
  uint64_t* empty = full + kStages;

  const int n_item_rows = kDKV ? nk : nq, n_tile_rows = kDKV ? nq : nk;
  const int n_tiles = (n_tile_rows + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    hop::mbar_init(it_full, 1);
    hop::mbar_init(it_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread, and in the dK/dV pass the 32 lanes that stage lse, D
      hop::mbar_init(&full[s], kDKV ? 33 : 1);
      hop::mbar_init(&empty[s], 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: per item A1, A2; then B1, B2 tiles through the ring ----
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tma1);
      hop::prefetch_map(&tma2);
      hop::prefetch_map(&tmb1);
      hop::prefetch_map(&tmb2);
      int stage = 0;
      uint32_t phase = 0, it_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int bh = item / item_tiles, b = bh / H, h = bh % H;
        const int r0 = item % item_tiles * kItemRows;
        hop::mbar_wait(it_empty, it_phase ^ 1);
        hop::mbar_expect_tx(it_full, 2 * S::kItem);
#pragma unroll
        for (int j = 0; j < kSlabs; ++j) {
          hop::tma_load_4d(sa + j * S::kSlabItem, &tma1, it_full, j * kSlab,
                           h, r0, b);
          hop::tma_load_4d(sa + S::kItem + j * S::kSlabItem, &tma2, it_full,
                           j * kSlab, h, r0, b);
        }
        it_phase ^= 1;
        for (int t = 0; t < n_tiles; ++t) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sb = ring + stage * S::kStage;
          hop::mbar_expect_tx(&full[stage], S::kStage);
#pragma unroll
          for (int j = 0; j < kSlabs; ++j) {
            hop::tma_load_4d(sb + j * S::kSlabTile, &tmb1, &full[stage],
                             j * kSlab, h, t * kTile, b);
            hop::tma_load_4d(sb + S::kTileB + j * S::kSlabTile, &tmb2,
                             &full[stage], j * kSlab, h, t * kTile, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (kDKV && threadIdx.x / 32 == 9) {
      // lse (base 2) and D of each query tile into its stage's stats
      const int lane = threadIdx.x % 32;
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int bh = item / item_tiles;
        const float* lse_row = lse + (long long)bh * nq;
        const float* d_row = delta + (long long)bh * nq;
        for (int t = 0; t < n_tiles; ++t) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          float* st = stats + stage * 2 * kTile;
#pragma unroll
          for (int i = lane; i < kTile; i += 32) {
            const int r = t * kTile + i;
            st[i] = r < nq ? lse_row[r] * kLog2e : __int_as_float(0x7f800000);
            st[kTile + i] = r < nq ? d_row[r] : 0.f;
          }
          hop::mbar_arrive(&full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 item rows each ----
    hop::setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x % 32, w = threadIdx.x % 128 / 32;
    const int g = lane / 4, c4 = lane % 4;
    const float scale_log2 = sm_scale * kLog2e;
    const uint8_t* a1_rows = sa + wg * 64 * (kSlab * 2);
    const uint8_t* a2_rows = a1_rows + S::kItem;
    float acc1[D / 2];                 // dQ or dK
    float acc2[kDKV ? D / 2 : 1];      // dV
    float x[kTile / 2], y[kTile / 2];  // S and dP, or S^T and dP^T
    uint32_t pp[kTile / 16][4], pd[kTile / 16][4];  // P^T and dS (or dS^T)

    // X = A1 B1^T and Y = A2 B2^T: K-major on d under the 64-byte swizzle,
    // one slab per two k16 steps
    auto issue_xy = [&](const uint8_t* sb) {
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 2) * S::kSlabItem + (kk % 2) * 32;
        const int toff = (kk / 2) * S::kSlabTile + (kk % 2) * 32;
        hop::Wgmma<kTile>::ss(x, hop::make_desc(a1_rows + off, 64, 16, 512),
                              hop::make_desc(sb + toff, 64, 16, 512), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 2) * S::kSlabItem + (kk % 2) * 32;
        const int toff = (kk / 2) * S::kSlabTile + (kk % 2) * 32;
        hop::Wgmma<kTile>::ss(y, hop::make_desc(a2_rows + off, 64, 16, 512),
                              hop::make_desc(sb + S::kTileB + toff, 64, 16,
                                             512),
                              kk > 0);
      }
      hop::wgmma_commit();
    };
    // acc += A B with A from registers (16 tile rows a k16 step) and B a
    // tile tensor read d-major with the transpose bit: 16 rows are 2 groups
    // of 8 (SBO 512), d/32 slabs (LBO)
    auto issue_rs = [&](float(&acc)[D / 2], const uint32_t(&a)[kTile / 16][4],
                        const uint8_t* sb) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        hop::Wgmma<D>::rs_t(acc, a[kk],
                            hop::make_desc(sb + kk * 1024, 64, S::kSlabTile,
                                           512),
                            1);
    };
    auto pack = [&](uint32_t(&a)[kTile / 16][4], const float(&v)[kTile / 2]) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        a[kk][0] = pack_bf16(v[8 * kk], v[8 * kk + 1]);
        a[kk][1] = pack_bf16(v[8 * kk + 2], v[8 * kk + 3]);
        a[kk][2] = pack_bf16(v[8 * kk + 4], v[8 * kk + 5]);
        a[kk][3] = pack_bf16(v[8 * kk + 6], v[8 * kk + 7]);
      }
    };

    int stage = 0;
    uint32_t phase = 0, it_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int bh = item / item_tiles, b = bh / H, h = bh % H;
      const int r0 = item % item_tiles * kItemRows;
      const int ra = r0 + wg * 64 + w * 16 + g, rb = ra + 8;  // item rows
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc1[i] = 0.f;
      if constexpr (kDKV) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc2[i] = 0.f;
      }
      // dQ: the rows' lse (base 2) and D; a row >= nq gets lse = +inf and
      // D = 0, so P = dS = 0. dK/dV: whether the rows are real keys.
      float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
      const bool ok[2] = {ra < n_item_rows, rb < n_item_rows};
      if constexpr (!kDKV) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? rb : ra;
          lse2[r] = ok[r] ? lse[(long long)bh * nq + row] * kLog2e
                          : __int_as_float(0x7f800000);
          dl[r] = ok[r] ? delta[(long long)bh * nq + row] : 0.f;
        }
      }
      hop::mbar_wait(it_full, it_phase);
      it_phase ^= 1;

      for (int t = 0; t < n_tiles; ++t) {
        hop::mbar_wait(&full[stage], phase);
        const uint8_t* sb = ring + stage * S::kStage;
        issue_xy(sb);
        hop::wgmma_wait<0>();
        hop::fence_regs(x);
        hop::fence_regs(y);
        if (t == n_tiles - 1 && lane == 0) hop::mbar_arrive(it_empty);
        // columns: tile rows t*64 + 8j + 2 c4 + {0, 1}
        const int valid = n_tile_rows - t * kTile;
        const float* st = stats + stage * 2 * kTile;
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * c4 + (e & 1), r = e >> 1;
            float p, dd;
            if constexpr (kDKV) {
              p = col < valid && ok[r]
                      ? exp2f(x[4 * j + e] * scale_log2 - st[col])
                      : 0.f;
              dd = st[kTile + col];
            } else {
              p = col < valid ? exp2f(x[4 * j + e] * scale_log2 - lse2[r])
                              : 0.f;
              dd = dl[r];
            }
            x[4 * j + e] = p;
            y[4 * j + e] = p * (y[4 * j + e] - dd);
          }
        }
        pack(pd, y);
        if constexpr (kDKV) pack(pp, x);
        hop::wgmma_fence();
        if constexpr (kDKV) issue_rs(acc2, pp, sb + S::kTileB);  // dV += P^T dO
        issue_rs(acc1, pd, sb);  // dQ += dS K, or dK += dS^T Q
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(acc1);
        hop::fence_regs(pd);
        if constexpr (kDKV) {
          hop::fence_regs(acc2);
          hop::fence_regs(pp);
        }
        if (lane == 0) hop::mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // ---- store the item rows < n_item_rows ----
      __nv_bfloat16* o1 = out1 + b * so1.b + h * so1.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + 2 * c4;
        if (ok[0])
          *reinterpret_cast<uint32_t*>(o1 + ra * so1.n + c) = pack_bf16(
              acc1[4 * j] * sm_scale, acc1[4 * j + 1] * sm_scale);
        if (ok[1])
          *reinterpret_cast<uint32_t*>(o1 + rb * so1.n + c) = pack_bf16(
              acc1[4 * j + 2] * sm_scale, acc1[4 * j + 3] * sm_scale);
      }
      if constexpr (kDKV) {
        __nv_bfloat16* o2 = out2 + b * so2.b + h * so2.h;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int c = j * 8 + 2 * c4;
          if (ok[0])
            *reinterpret_cast<uint32_t*>(o2 + ra * so2.n + c) =
                pack_bf16(acc2[4 * j], acc2[4 * j + 1]);
          if (ok[1])
            *reinterpret_cast<uint32_t*>(o2 + rb * so2.n + c) =
                pack_bf16(acc2[4 * j + 2], acc2[4 * j + 3]);
        }
      }
    }
  }
}

template <int D, bool kDKV>
cudaError_t launch_pass(cudaStream_t st, const CUtensorMap& a1,
                        const CUtensorMap& a2, const CUtensorMap& b1,
                        const CUtensorMap& b2, const float* lse,
                        const float* delta, __nv_bfloat16* out1,
                        __nv_bfloat16* out2, Strides so1, Strides so2, int B,
                        int H, int nq, int nk, float sm_scale) {
  using S = BwdSmem<D>;
  static cudaError_t attr =
      hop_host::allow_smem(flash_bwd_kernel<D, kDKV>, S::kSmem);
  if (attr != cudaSuccess) return attr;
  // the consumers' setmaxnreg.inc needs the pool of a 168-register launch
  static const int regs = [] {
    cudaFuncAttributes fa;
    return cudaFuncGetAttributes(&fa, flash_bwd_kernel<D, kDKV>) ==
                   cudaSuccess
               ? fa.numRegs
               : 0;
  }();
  if (regs < kLaunchRegs) return cudaErrorInvalidConfiguration;
  const int item_tiles = ((kDKV ? nk : nq) + kItemRows - 1) / kItemRows;
  const long long items = (long long)item_tiles * B * H;
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  const int n_items = static_cast<int>(items);
  const int sms = hop_host::sm_count();
  const int blocks = n_items < sms ? n_items : sms;
  flash_bwd_kernel<D, kDKV><<<blocks, S::kThreads, S::kSmem, st>>>(
      a1, a2, b1, b2, lse, delta, out1, out2, so1, so2, H, nq, nk,
      item_tiles, n_items, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       __nv_bfloat16* dq, __nv_bfloat16* dk,
                       __nv_bfloat16* dv, int B, int H, int nq, int nk,
                       Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdq, Strides sdk, Strides sdv, float sm_scale,
                       cudaStream_t st) {
  // item maps in boxes of 128 rows, streamed ones in boxes of 64
  CUtensorMap k_item, v_item, q_tile, do_tile, q_item, do_item, k_tile,
      v_tile;
  if (!bnhd_map(&k_item, k, B, nk, H, D, sk, kItemRows) ||
      !bnhd_map(&v_item, v, B, nk, H, D, sv, kItemRows) ||
      !bnhd_map(&q_tile, q, B, nq, H, D, sq, kTile) ||
      !bnhd_map(&do_tile, dout, B, nq, H, D, sdo, kTile) ||
      !bnhd_map(&q_item, q, B, nq, H, D, sq, kItemRows) ||
      !bnhd_map(&do_item, dout, B, nq, H, D, sdo, kItemRows) ||
      !bnhd_map(&k_tile, k, B, nk, H, D, sk, kTile) ||
      !bnhd_map(&v_tile, v, B, nk, H, D, sv, kTile))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_pass<D, true>(st, k_item, v_item, q_tile, do_tile,
                                         lse, delta, dk, dv, sdk, sdv, B, H,
                                         nq, nk, sm_scale);
  if (err != cudaSuccess) return err;
  return launch_pass<D, false>(st, q_item, do_item, k_tile, v_tile, lse,
                               delta, dq, nullptr, sdq, sdq, B, H, nq, nk,
                               sm_scale);
}

}  // namespace

extern "C" {

// q, dout, dq: [B, nq, H, d]; k, v, dk, dv: [B, nk, H, d], bf16, by element
// strides (batch, token, head); lse, delta: contiguous f32 [B, H, nq].
int flash_attn_bf16_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, int B, int H, int nq,
                        int nk, int d, long long q_sb, long long q_sn,
                        long long q_sh, long long k_sb, long long k_sn,
                        long long k_sh, long long v_sb, long long v_sn,
                        long long v_sh, long long do_sb, long long do_sn,
                        long long do_sh, long long dq_sb, long long dq_sn,
                        long long dq_sh, long long dk_sb, long long dk_sn,
                        long long dk_sh, long long dv_sb, long long dv_sn,
                        long long dv_sh, float sm_scale, void* stream) {
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, sdo{do_sb, do_sn, do_sh}, sdq{dq_sb, dq_sn, dq_sh},
      sdk{dk_sb, dk_sn, dk_sh}, sdv{dv_sb, dv_sn, dv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto lp = static_cast<const float*>(lse);
  auto dlp = static_cast<const float*>(delta);
  auto dqp = static_cast<__nv_bfloat16*>(dq);
  auto dkp = static_cast<__nv_bfloat16*>(dk);
  auto dvp = static_cast<__nv_bfloat16*>(dv);
  cudaError_t err;
  if (d == 128)
    err = launch_bwd<128>(q, k, v, dout, lp, dlp, dqp, dkp, dvp, B, H, nq, nk,
                          sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else if (d == 96)
    err = launch_bwd<96>(q, k, v, dout, lp, dlp, dqp, dkp, dvp, B, H, nq, nk,
                         sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else if (d == 64)
    err = launch_bwd<64>(q, k, v, dout, lp, dlp, dqp, dkp, dvp, B, H, nq, nk,
                         sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
