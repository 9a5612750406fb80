// Non-causal f32 attention forward for Hopper (sm_90a), behind a plain C
// interface (loaded with ctypes by infinicube_tpu_torch/kernels).
//
// flash_attn_f32 replaces the library Pallas TPU flash attention
//   (jax.experimental.pallas.ops.tpu.flash_attention, called at
//   infinicube_tpu/ops/attention.py:72) and the f32 einsum attention beside
//   it (:19-22) for f32 inputs, which the reference serves in the inputs'
//   dtype: an f32 UNet's SelfAttention3D (N = 4,096 and 512, 8 heads of
//   96), an f32 DiT's cross-attention, the GSM pixel branch's SelfAttn2D (4
//   heads of 64). It computes softmax(q k^T * sm_scale) v to f32 accuracy:
//   f32 logits, an online softmax with an f32 running max and sum, f32 PV.
//   [B, N, h, d] strided views, Nq != Nk allowed, keys >= Nk masked, d = 64,
//   96 or 128. On request it also stores each row's natural log-sum-exp
//   (f32 [B, h, Nq], one store a row), which its backward,
//   flash_attn_f32_bwd (flash_attention_f32_bwd.cu), takes.
//
// What bounds it: 4*Nq*Nk*d f32 operations a (batch, head) against
// (2 Nq + 2 Nk)*d*4 bytes: operations. On the CUDA cores (67 TFLOP/s) the
// first version, FFMA on thread-staged tiles, one block per 64 query rows,
// reached 42 % of that at N = 4,096 and lost to SDPA in f32.
//
// Design: both products on the tensor cores by the 3xTF32 split (as K4 and
// the f32 conv): a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), and a
// product taken as lo_A hi_B + hi_A lo_B + hi_A hi_B on wgmma m64nNk8
// .f32.tf32.tf32 with f32 accumulators; three products at 495 TFLOP/s bound
// it at 165 TFLOP/s of f32 work. A call runs up to three kernels, counted as
// one launch:
// - a prologue pass writes K's tf32 hi and lo [2, B*h, Nk, d] and V's
//   transposed, [2, B*h, d, Nkp] (keys contiguous, Nkp = Nk rounded up to 8,
//   zeros past Nk): tf32 wgmma has no transpose bit, so V, the B operand of
//   PV, must be key-major. Within each group of 8 keys Vt stores them in the
//   order 0, 2, 4, 6, 1, 3, 5, 7: a thread's logit accumulators hold keys
//   2t and 2t+1 of each 8 where the tf32 A fragment wants columns t and
//   t+4, so with V's keys permuted alike P goes from the S accumulators
//   straight into PV's A operand, with no shuffle and no trip through
//   shared memory.
// - the main kernel, persistent, one block per SM over work items (batch *
//   head, 128 query rows, a range of key tiles): two consumer warpgroups of
//   64 rows and a producer warpgroup whose registers go to the consumers
//   (setmaxnreg, as K2). Q is read once an item into registers and split
//   there (its hi and lo A fragments, d registers a thread); K hi and lo
//   and Vt hi and lo stream through a ring of KT-key stages by TMA (32
//   columns, 128 bytes, a row under the 128-byte swizzle). KT is 64 keys at
//   d = 64, 32 at 96, 16 at 128, which keeps Q's fragments, S, P's lo
//   fragments and the output in the consumers' 240 registers and a stage
//   (16 * d * KT bytes) at 3-6 in the ring. Per tile each warpgroup issues
//   S = Q K^T (three products a k8 step, Q from registers), runs the online
//   softmax on the accumulators, splits P in registers and issues P V; the
//   two warpgroups' softmaxes overlap each other's products. The tensor
//   cores truncate every sum they accumulate (round toward zero), which
//   drifts over thousands of keys: at d = 64 and 96 each tile's P V goes
//   into sums of its own, added into the output with a rounded FMA (O =
//   O * alpha + PV); at d = 128 the registers are spent (Q's fragments alone
//   take 128), so PV accumulates into O across the tiles.
// - where query tiles x heads fall short of the SMs (the UNet's N = 512
//   with 8 heads makes 32 items for 132 SMs) the keys are split into S
//   ranges: each item writes its unnormalized output, its row max and its
//   row sum, and a combine pass merges the ranges in order s = 0 .. S-1,
//   so two runs are bit-identical.
//
// Tensors are addressed by element strides (batch, token, head). The entry
// points return cudaGetLastError() (or cudaErrorInvalidValue for what they
// do not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;       // query rows of a work item
constexpr int kThreads = 384;    // warpgroups 0, 1 consume, 2 produces
constexpr int kRing = 196608;    // bytes of shared memory for the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// registers a thread after the hand-over (as K2): the producer warpgroup
// keeps 24, each consumer takes 240, from the pool of a 168-register launch
constexpr int kProducerRegs = 24, kConsumerRegs = 240, kLaunchRegs = 168;

struct Strides {
  long long b, n, h;  // elements between batches, tokens, heads
};

template <int D>
struct F32Tile {
  static constexpr int kKT = D == 64 ? 64 : D == 96 ? 32 : 16;  // keys a tile
  static constexpr int kSpanV = kKT >= 32 ? 128 : kKT * 4;  // Vt row bytes
  static constexpr int kSlabK = kKT * 128;          // 32 columns of K
  static constexpr int kK = (D / 32) * kSlabK;      // K hi (or lo)
  static constexpr int kSlabV = D * kSpanV;         // kSpanV / 4 keys of Vt
  static constexpr int kV = kKT * 4 / kSpanV * kSlabV;  // Vt hi (or lo)
  static constexpr int kStage = 2 * kK + 2 * kV;
  static constexpr int kStages = kRing / kStage > 6 ? 6 : kRing / kStage;
  static constexpr int kSmem = kStages * kStage + 2 * 8 * kStages + 1024;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

// the position, in its group of 8, of key j in Vt's order 0, 2, 4, 6, 1, 3,
// 5, 7 (the key at position p is 2 (p % 4) + p / 4)
__device__ __forceinline__ int key_at(int p) { return 2 * (p % 4) + p / 4; }

// K -> ks [2, BH, nk, D] (hi, lo); V -> vt [2, BH, D, nkp] (hi, lo), keys in
// Vt's order, zeros past nk. One block a (batch*head, 32 keys).
template <int D>
__global__ void __launch_bounds__(256)
    f32_attn_prep_kernel(const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ ks,
                         float* __restrict__ vt, int H, int nk, int nkp,
                         Strides sk, Strides sv) {
  __shared__ float tile[32][D + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long BH = gridDim.y;
  const int k0 = blockIdx.x * 32;
  for (int i = threadIdx.x; i < 32 * D / 4; i += blockDim.x) {
    const int r = i / (D / 4), c = i % (D / 4) * 4;
    const int key = k0 + r;
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < nk) {
      const float4 kv = *reinterpret_cast<const float4*>(
          k + b * sk.b + key * sk.n + h * sk.h + c);
      float4 hi, lo;
      hi.x = tf32_trunc(kv.x);
      hi.y = tf32_trunc(kv.y);
      hi.z = tf32_trunc(kv.z);
      hi.w = tf32_trunc(kv.w);
      lo.x = tf32_trunc(kv.x - hi.x);
      lo.y = tf32_trunc(kv.y - hi.y);
      lo.z = tf32_trunc(kv.z - hi.z);
      lo.w = tf32_trunc(kv.w - hi.w);
      *reinterpret_cast<float4*>(ks + ((long long)bh * nk + key) * D + c) =
          hi;
      *reinterpret_cast<float4*>(
          ks + ((BH + bh) * nk + key) * D + c) = lo;
      vv = *reinterpret_cast<const float4*>(v + b * sv.b + key * sv.n +
                                            h * sv.h + c);
    }
    tile[r][c] = vv.x;
    tile[r][c + 1] = vv.y;
    tile[r][c + 2] = vv.z;
    tile[r][c + 3] = vv.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * D; i += blockDim.x) {
    const int c = i / 32, p = i % 32;
    if (k0 + p >= nkp) continue;
    const float val = tile[p / 8 * 8 + key_at(p % 8)][c];
    const float hi = tf32_trunc(val);
    vt[((long long)bh * D + c) * nkp + k0 + p] = hi;
    vt[((BH + bh) * D + c) * nkp + k0 + p] = tf32_trunc(val - hi);
  }
}

// Scale to base 2, mask keys >= kvalid, and run the online softmax over one
// 64 x KT logit tile (rows g: s[4j], s[4j+1]; rows g+8: s[4j+2], s[4j+3]):
// s becomes P (f32), m and l are updated (l per thread, summed over the
// row's four threads at the end), and alpha[r] is the factor the output
// rows must be rescaled by.
template <int KT>
__device__ __forceinline__ void softmax_tile(float (&s)[KT / 2], int kvalid,
                                             int q, float scale_log2,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] *= scale_log2;
      if (j * 8 + 2 * q + (e & 1) >= kvalid) s[4 * j + e] = neg_inf();
    }
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // every tile holds at least one real key, so mx is finite here
  alpha[0] = exp2f(m[0] - mx[0]);
  alpha[1] = exp2f(m[1] - mx[1]);
  m[0] = mx[0];
  m[1] = mx[1];
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    s[4 * j] = exp2f(s[4 * j] - mx[0]);
    s[4 * j + 1] = exp2f(s[4 * j + 1] - mx[0]);
    s[4 * j + 2] = exp2f(s[4 * j + 2] - mx[1]);
    s[4 * j + 3] = exp2f(s[4 * j + 3] - mx[1]);
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l[0] = l[0] * alpha[0] + sum0;
  l[1] = l[1] * alpha[1] + sum1;
}

struct F32Args {
  const float* q;       // [B, nq, H, D] by element strides sq
  float* o;             // [B, nq, H, D] by element strides so (one range)
  float* part_o;        // [S, BH, nq, D] unnormalized, or null
  float* part_ml;       // [S, BH, nq, 2] (base-2 row max, row sum), or null
  float* lse;           // [BH, nq] natural log-sum-exp, or null
  int H, BH, nq, nk, q_tiles, splits, per_split, n_items;
  Strides sq, so;
  float scale_log2;
};

// Work item i: (bh, query tile, key range), the key range fastest.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_f32_tf32x3_kernel(const __grid_constant__ CUtensorMap tmk,
                            const __grid_constant__ CUtensorMap tmv,
                            const F32Args a) {
  using T = F32Tile<D>;
  constexpr int KT = T::kKT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStage);
  uint64_t* empty = full + T::kStages;
  const int n_tiles = (a.nk + KT - 1) / KT;

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
    // ---- producer: K hi, lo and Vt hi, lo of every tile through the ring
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tmk);
      hop::prefetch_map(&tmv);
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const int bh = item / a.splits / a.q_tiles;
        const int t0 = item % a.splits * a.per_split;
        const int t1 = min(n_tiles, t0 + a.per_split);
        for (int t = t0; t < t1; ++t) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * T::kStage;
          hop::mbar_expect_tx(&full[stage], T::kStage);
#pragma unroll
          for (int j = 0; j < D / 32; ++j) {
            hop::tma_load_3d(st + j * T::kSlabK, &tmk, &full[stage], 32 * j,
                             t * KT, bh);
            hop::tma_load_3d(st + T::kK + j * T::kSlabK, &tmk, &full[stage],
                             32 * j, t * KT, a.BH + bh);
          }
#pragma unroll
          for (int j = 0; j < T::kV / T::kSlabV; ++j) {
            const int key = t * KT + j * T::kSpanV / 4;
            hop::tma_load_3d(st + 2 * T::kK + j * T::kSlabV, &tmv,
                             &full[stage], key, 0, bh);
            hop::tma_load_3d(st + 2 * T::kK + T::kV + j * T::kSlabV, &tmv,
                             &full[stage], key, 0, a.BH + bh);
          }
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    hop::setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x % 32, w = threadIdx.x % 128 / 32;
    const int g = lane / 4, q = lane % 4;
    uint32_t qh[D / 8][4], ql[D / 8][4];  // Q's A fragments, hi and lo
    uint32_t ph[KT / 8][4], pl[KT / 8][4];  // P's
    // d <= 96: each tile's P V in sums of its own, added into o_acc with a
    // rounded FMA (the tensor cores truncate every sum they accumulate, which
    // drifts over thousands of keys); d = 128 has no registers left for them
    constexpr bool kFresh = D <= 96;
    float s[KT / 2], o_acc[D / 2], pv[kFresh ? D / 2 : 1];
    float m[2], l[2], alpha[2];
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      const int sp = item % a.splits;
      const int bh = item / a.splits / a.q_tiles, b = bh / a.H, h = bh % a.H;
      const int ra =
          item / a.splits % a.q_tiles * kRows + wg * 64 + w * 16 + g;
      const int rb = ra + 8;
      const int t0 = sp * a.per_split;
      const int t1 = min(n_tiles, t0 + a.per_split);
      // Q's rows ra and rb, split into A fragments: a[0] (ra, column c),
      // a[1] (rb, c), a[2] (ra, c + 4), a[3] (rb, c + 4), c = 8 kk + q
      const float* qb = a.q + b * a.sq.b + h * a.sq.h;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r % 2 ? rb : ra;
          const int c = 8 * kk + q + 4 * (r / 2);
          const float x = row < a.nq ? qb[row * a.sq.n + c] : 0.f;
          const float hi = tf32_trunc(x);
          qh[kk][r] = __float_as_uint(hi);
          ql[kk][r] = __float_as_uint(tf32_trunc(x - hi));
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
      m[0] = m[1] = neg_inf();
      l[0] = l[1] = 0.f;

      for (int t = t0; t < t1; ++t) {
        hop::mbar_wait(&full[stage], phase);
        const uint8_t* sk = ring + stage * T::kStage;
        const uint8_t* sv = sk + 2 * T::kK;
        // S = Q K^T: K K-major, 32 columns (128 bytes) a row of each slab
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const uint8_t* kh = sk + kk / 4 * T::kSlabK + kk % 4 * 32;
          const uint64_t dh = hop::make_desc(kh, 128, 16, 1024);
          const uint64_t dl = hop::make_desc(kh + T::kK, 128, 16, 1024);
          hop::WgmmaTf32<KT>::rs(s, ql[kk], dh, kk > 0);
          hop::WgmmaTf32<KT>::rs(s, qh[kk], dl, 1);
          hop::WgmmaTf32<KT>::rs(s, qh[kk], dh, 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(s);
        hop::fence_regs(qh);
        hop::fence_regs(ql);
        softmax_tile<KT>(s, a.nk - t * KT, q, a.scale_log2, m, l, alpha);
        if constexpr (!kFresh) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o_acc[4 * j] *= alpha[0];
            o_acc[4 * j + 1] *= alpha[0];
            o_acc[4 * j + 2] *= alpha[1];
            o_acc[4 * j + 3] *= alpha[1];
          }
        }
        // P as A fragments: keys 2q and 2q+1 of each 8 (s[4j], s[4j+1] of
        // row g, s[4j+2], s[4j+3] of row g+8) are columns q and q+4, which
        // Vt's key order matches
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = s[4 * j + (r % 2) * 2 + r / 2];
            const float hi = tf32_trunc(p);
            ph[j][r] = __float_as_uint(hi);
            pl[j][r] = __float_as_uint(tf32_trunc(p - hi));
          }
        }
        // O += P V: Vt K-major, kSpanV bytes of keys a row of each slab
        hop::wgmma_fence();
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const uint8_t* vh =
              sv + j * 32 / T::kSpanV * T::kSlabV + j * 32 % T::kSpanV;
          const uint64_t dh = hop::make_desc(vh, T::kSpanV, 16, 8 * T::kSpanV);
          const uint64_t dl =
              hop::make_desc(vh + T::kV, T::kSpanV, 16, 8 * T::kSpanV);
          if constexpr (kFresh) {
            hop::WgmmaTf32<D>::rs(pv, pl[j], dh, j > 0);
            hop::WgmmaTf32<D>::rs(pv, ph[j], dl, 1);
            hop::WgmmaTf32<D>::rs(pv, ph[j], dh, 1);
          } else {
            hop::WgmmaTf32<D>::rs(o_acc, pl[j], dh, 1);
            hop::WgmmaTf32<D>::rs(o_acc, ph[j], dl, 1);
            hop::WgmmaTf32<D>::rs(o_acc, ph[j], dh, 1);
          }
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(o_acc);
        if constexpr (kFresh) {
          hop::fence_regs(pv);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o_acc[4 * j] = fmaf(o_acc[4 * j], alpha[0], pv[4 * j]);
            o_acc[4 * j + 1] = fmaf(o_acc[4 * j + 1], alpha[0], pv[4 * j + 1]);
            o_acc[4 * j + 2] = fmaf(o_acc[4 * j + 2], alpha[1], pv[4 * j + 2]);
            o_acc[4 * j + 3] = fmaf(o_acc[4 * j + 3], alpha[1], pv[4 * j + 3]);
          }
        }
        hop::fence_regs(ph);
        hop::fence_regs(pl);
        if (lane == 0) hop::mbar_arrive(&empty[stage]);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // ---- rows < nq: normalized, or this range's unnormalized output
      // with its row max and sum ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      float inv[2] = {1.f, 1.f};
      float* base[2];
      if (a.splits == 1) {
        inv[0] = 1.f / l[0];
        inv[1] = 1.f / l[1];
        float* ob = a.o + b * a.so.b + h * a.so.h;
        base[0] = ob + ra * a.so.n;
        base[1] = ob + rb * a.so.n;
        if (a.lse != nullptr && q == 0) {
          if (ra < a.nq)
            a.lse[(long long)bh * a.nq + ra] = (m[0] + log2f(l[0])) * kLn2;
          if (rb < a.nq)
            a.lse[(long long)bh * a.nq + rb] = (m[1] + log2f(l[1])) * kLn2;
        }
      } else {
        float* po = a.part_o + ((long long)sp * a.BH + bh) * a.nq * D;
        base[0] = po + (long long)ra * D;
        base[1] = po + (long long)rb * D;
        float* ml = a.part_ml + ((long long)sp * a.BH + bh) * a.nq * 2;
        if (q == 0) {
          if (ra < a.nq)
            *reinterpret_cast<float2*>(ml + 2 * ra) = make_float2(m[0], l[0]);
          if (rb < a.nq)
            *reinterpret_cast<float2*>(ml + 2 * rb) = make_float2(m[1], l[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + 2 * q;
        if (ra < a.nq)
          *reinterpret_cast<float2*>(base[0] + c) =
              make_float2(o_acc[4 * j] * inv[0], o_acc[4 * j + 1] * inv[0]);
        if (rb < a.nq)
          *reinterpret_cast<float2*>(base[1] + c) = make_float2(
              o_acc[4 * j + 2] * inv[1], o_acc[4 * j + 3] * inv[1]);
      }
    }
  }
}

// o = (sum_s 2^(m_s - M) O_s) / (sum_s 2^(m_s - M) l_s), M = max_s m_s,
// summed in order s = 0 .. S-1; four columns a thread. With lse, the row's
// natural log-sum-exp (M + log2 of the sum of l) ln 2 too.
template <int D>
__global__ void __launch_bounds__(256)
    f32_attn_combine_kernel(const float* __restrict__ part_o,
                            const float* __restrict__ part_ml,
                            float* __restrict__ o, float* __restrict__ lse,
                            int H, int nq, int splits, long long rows,
                            Strides so) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * (D / 4)) return;
  const long long row = i / (D / 4);  // bh * nq + r
  const int c = static_cast<int>(i % (D / 4)) * 4;
  float mx = neg_inf();
  for (int sp = 0; sp < splits; ++sp)
    mx = fmaxf(mx, part_ml[(sp * rows + row) * 2]);
  float den = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float2 ml =
        *reinterpret_cast<const float2*>(part_ml + (sp * rows + row) * 2);
    const float f = exp2f(ml.x - mx);
    den += ml.y * f;
    const float4 p =
        *reinterpret_cast<const float4*>(part_o + (sp * rows + row) * D + c);
    acc.x += p.x * f;
    acc.y += p.y * f;
    acc.z += p.z * f;
    acc.w += p.w * f;
  }
  const float inv = 1.f / den;
  if (lse != nullptr && c == 0) lse[row] = (mx + log2f(den)) * kLn2;
  const int bh = static_cast<int>(row / nq), r = static_cast<int>(row % nq);
  *reinterpret_cast<float4*>(o + bh / H * so.b + r * so.n + bh % H * so.h +
                             c) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The key ranges of a call: S and the key tiles a range. S minimizes a
// model of the time: ceil(items * S / sms) waves of items each 1/S of an
// unsplit item (3 * 4 * 128 * nk * d TF32 operations at an H100's 495
// TFLOP/s shared by its SMs), plus the combine pass's bytes (S partial
// outputs written and read back at 3.35 TB/s); at most one range a key
// tile, and 16.
void plan_splits(int BH, int nq, int nk, int d, int kt, int sms,
                 int* splits, int* per_split) {
  const int q_tiles = (nq + kRows - 1) / kRows;
  const int n_tiles = (nk + kt - 1) / kt;
  const long long items = (long long)q_tiles * BH;
  const double t_item = 12.0 * kRows * nk * d / (495e12 / sms);
  int best = 1;
  double cost = 1e30;
  for (int s = 1; s <= 16 && s <= n_tiles && sms > 0; ++s) {
    const double waves = static_cast<double>((items * s + sms - 1) / sms);
    const double comb =
        s > 1 ? 2.0 * s * BH * static_cast<double>(nq) * d * 4 / 3.35e12 : 0;
    const double c = waves * t_item / s + comb;
    if (c < cost) {
      cost = c;
      best = s;
    }
  }
  *per_split = (n_tiles + best - 1) / best;
  *splits = (n_tiles + *per_split - 1) / *per_split;  // none left empty
}

int key_tile(int d) { return d == 64 ? 64 : d == 96 ? 32 : 16; }

template <int D>
cudaError_t launch_f32(cudaStream_t st, const float* q, const float* k,
                       const float* v, float* o, float* ks, float* vt,
                       float* part_o, float* part_ml, float* lse, int B,
                       int H, int nq, int nk, int splits, int per_split,
                       int sms,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale_log2) {
  using T = F32Tile<D>;
  const int BH = B * H;
  const int nkp = round_up(nk, 8);
  if (BH > 65535) return cudaErrorInvalidValue;
  f32_attn_prep_kernel<D><<<dim3((nkp + 31) / 32, BH), 256, 0, st>>>(
      k, v, ks, vt, H, nk, nkp, sk, sv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  CUtensorMap tmk, tmv;
  const uint64_t kd[3] = {(uint64_t)D, (uint64_t)nk, (uint64_t)2 * BH};
  const uint64_t kst[2] = {(uint64_t)D * 4, (uint64_t)nk * D * 4};
  const uint32_t kb[3] = {32, (uint32_t)T::kKT, 1};
  const uint64_t vd[3] = {(uint64_t)nkp, (uint64_t)D, (uint64_t)2 * BH};
  const uint64_t vst[2] = {(uint64_t)nkp * 4, (uint64_t)D * nkp * 4};
  const uint32_t vb[3] = {(uint32_t)T::kSpanV / 4, (uint32_t)D, 1};
  if (!hop_host::make_map(&tmk, ks, 3, kd, kst, kb, 128,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !hop_host::make_map(&tmv, vt, 3, vd, vst, vb, T::kSpanV,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  static cudaError_t attr =
      hop_host::allow_smem(flash_f32_tf32x3_kernel<D>, T::kSmem);
  if (attr != cudaSuccess) return attr;
  // the consumers' setmaxnreg.inc needs the pool of a 168-register launch
  static const int regs = [] {
    cudaFuncAttributes fa;
    return cudaFuncGetAttributes(&fa, flash_f32_tf32x3_kernel<D>) ==
                   cudaSuccess
               ? fa.numRegs
               : 0;
  }();
  if (regs < kLaunchRegs) return cudaErrorInvalidConfiguration;
  F32Args a;
  a.q = q;
  a.o = o;
  a.part_o = part_o;
  a.part_ml = part_ml;
  a.lse = lse;
  a.H = H;
  a.BH = BH;
  a.nq = nq;
  a.nk = nk;
  a.q_tiles = (nq + kRows - 1) / kRows;
  a.splits = splits;
  a.per_split = per_split;
  const long long items = (long long)a.q_tiles * BH * splits;
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  a.n_items = static_cast<int>(items);
  a.sq = sq;
  a.so = so;
  a.scale_log2 = scale_log2;
  const int blocks = a.n_items < sms ? a.n_items : sms;
  flash_f32_tf32x3_kernel<D><<<blocks, kThreads, T::kSmem, st>>>(tmk, tmv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long rows = (long long)BH * nq;
  const long long threads = rows * (D / 4);
  f32_attn_combine_kernel<D>
      <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
          part_o, part_ml, o, lse, H, nq, splits, rows, so);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of key ranges flash_attn_f32 takes on a card with `sms` SMs.
int flash_attn_f32_splits(int B, int H, int nq, int nk, int d, int sms) {
  int splits, per_split;
  plan_splits(B * H, nq, nk, d, key_tile(d), sms, &splits, &per_split);
  return splits;
}

// q, o: f32 [B, nq, H, d]; k, v: f32 [B, nk, H, d], by element strides
// (batch, token, head), 16-byte aligned. Scratch from the caller: ks f32
// [2, B*H, nk, d], vt f32 [2, B*H, d, nk rounded up to 8] and, with more
// than one key range (flash_attn_f32_splits), part_o f32 [splits, B*H, nq,
// d] and part_ml f32 [splits, B*H, nq, 2], else null. lse: f32 [B, H, nq]
// contiguous for each row's natural log-sum-exp, or null.
int flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                   void* ks, void* vt, void* part_o, void* part_ml, void* lse,
                   int B,
                   int H, int nq, int nk, int d, int splits, int sms,
                   long long q_sb, long long q_sn, long long q_sh,
                   long long k_sb, long long k_sn, long long k_sh,
                   long long v_sb, long long v_sn, long long v_sh,
                   long long o_sb, long long o_sn, long long o_sh,
                   float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || nq <= 0 || nk <= 0 || sms <= 0 ||
      (d != 64 && d != 96 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  int want, per_split;
  plan_splits(B * H, nq, nk, d, key_tile(d), sms, &want, &per_split);
  if (splits != want || (splits > 1) != (part_o != nullptr) ||
      (splits > 1) != (part_ml != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(o);
  auto ksp = static_cast<float*>(ks);
  auto vtp = static_cast<float*>(vt);
  auto po = static_cast<float*>(part_o);
  auto pml = static_cast<float*>(part_ml);
  auto lp = static_cast<float*>(lse);
  cudaError_t e;
  if (d == 128)
    e = launch_f32<128>(st, qp, kp, vp, op, ksp, vtp, po, pml, lp, B, H, nq,
                        nk, splits, per_split, sms, sq, sk, sv, so,
                        scale_log2);
  else if (d == 96)
    e = launch_f32<96>(st, qp, kp, vp, op, ksp, vtp, po, pml, lp, B, H, nq,
                       nk, splits, per_split, sms, sq, sk, sv, so,
                       scale_log2);
  else
    e = launch_f32<64>(st, qp, kp, vp, op, ksp, vtp, po, pml, lp, B, H, nq,
                       nk, splits, per_split, sms, sq, sk, sv, so,
                       scale_log2);
  return static_cast<int>(e);
}

}  // extern "C"
