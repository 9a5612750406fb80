// Non-causal flash attention for Hopper (sm_90a), forward: one kernel
// template behind three entry points with a plain C interface (loaded with
// ctypes by infinicube_tpu_torch/kernels). The backward of flash_attn_bf16
// is flash_attn_bf16_bwd (K5) in flash_attention_bwd.cu; flash_common.cuh
// holds what the two files share.
//
// flash_attn_int8qk (K1) replaces the int8-QK branch of the TPU kernel
//   infinicube_tpu/ops/flash_attention.py:263 `flash_attention`
//   (quant="qk", reached through `mha_quantized`), which runs the DiT's
//   self-attention on the serving path. Q and K arrive already quantized to
//   int8 with one f32 scale per (batch*head, block of rows), exactly as
//   `_block_quantize` makes them; QK^T runs on the int8 tensor cores with
//   int32 accumulation, the logits are scaled by sq * sk * sm_scale, and PV
//   runs in bf16 with f32 accumulation.
// flash_attn_int8qkv (K8) replaces the int8-PV branch of the same TPU kernel
//   (quant="qkv", `_kernel_body` :159-164 with `_channel_quantize` :239),
//   which the DiT's self-attention runs under WanDiTConfig(attn_quant="qkv").
//   Q and K as for K1; V arrives as int8 with one f32 scale per (batch*head,
//   channel), transposed to [batch*head, d, Npad] so that the keys of one
//   channel are contiguous, with the keys of each 16 permuted (below). P is
//   rounded to int8 at the fixed
//   scale 127 against the running max (the reference's int8(p * 127 +
//   0.5); here 127 p rounded to nearest, which differs at exact halves
//   only), and PV runs on the int8 tensor cores with int32 accumulation,
//   dequantized by sv / 127 per channel; the denominator sums the f32 P, as
//   in the reference.
// flash_attn_bf16 (K2) replaces the forward of the library Pallas TPU flash
//   attention (jax.experimental.pallas.ops.tpu.flash_attention) that
//   infinicube_tpu/ops/attention.py:25 `multi_head_attention` reaches on the
//   TPU: bf16 Q, K, V, Nq != Nk allowed, keys past Nk masked, head dim 64,
//   96 or 128. It serves the DiT's cross-attention to the text tokens and the
//   voxel UNet's SelfAttention3D (d = 96, N = 4,096 and 512). Like the
//   library kernel, which saves its row statistics l and m for the backward,
//   it can write one: with a non-null `lse` pointer it stores the natural
//   log-sum-exp of every query row's scaled logits, f32 [B, h, Nq], the only
//   statistic K5 needs. The serving paths pass null and store nothing more.
//
// What bounds them: at the DiT's shapes all three do ~4*Nq*Nk*d flops for
// ~(Nq + Nk)*d*6 bytes, far above the card's ~295 flop/byte ridge, so all
// three are tensor-core bound (K1 half int8, half bf16; K8 int8). The TPU
// kernel's fixed-max
// softmax and closed-form removal of padding mass were workarounds for the
// v5e's vector unit; here the softmax is the usual online running max in f32
// (exp2, log2(e) folded into the logit scale; the stored lse is converted to
// base e at the store), and keys >= n_real are masked.
//
// The design (on wgmma and TMA; one kernel template, K1 its int8
// instantiation, K8 the int8 one with an int8 V): persistent blocks, one
// per SM, each walking work items of
// (batch*head, 128 query rows): two consumer warpgroups of 64 rows and a
// producer warpgroup whose registers go to the consumers (setmaxnreg: 240
// each, 24 left). The first versions (4 warps of mma.sync per 64 rows, K and
// V loaded by the threads and then a barrier, K fragments read as scalar
// 32-bit words, the PV B operand built from four scalar bf16 loads and two
// packs per mma) are gone; now:
// - Q is loaded once an item and K and V stream through a 3-stage mbarrier
//   ring of 128-key tiles that runs on from item to item, all by TMA from
//   tensor maps built on the views' strides (dims d, h, N, B), so loads
//   overlap the math and no thread computes an address; the next item's Q
//   loads beside the current item's last PV and its stores. Rows past Nq
//   or Nk read as zeros; keys >= Nk are still masked.
// - Every bf16 tile is stored as slabs of 32 columns (64 bytes) under the
//   64-byte swizzle: d = 96 rows are 192 bytes, no multiple of the 128-byte
//   span, and three 64-byte slabs describe d = 64, 96 and 128 alike.
// - S = Q K^T is wgmma m64n128k16 with Q and K both K-major in shared
//   memory; the online softmax runs on the f32 accumulators in registers
//   (exp2, log2 e folded into the scale, running max and sum per row).
// - K1: Q8 and K8 are whole d-byte int8 rows (the folded [B*h, Npad, d]
//   buffers) under the d-byte swizzle (128 bytes at d = 128, 64 at d = 64),
//   both K-major, and S = Q8 K8^T is wgmma m64n128k32 .s32.s8.s8 (8-bit
//   wgmma has no transpose bit, and needs none: d is contiguous in both).
//   The int32 accumulators (|acc| <= 127^2 d < 2^24: exact in f32) are
//   converted and scaled by one float a tile, sq * sk * sm_scale * log2 e:
//   Npad and the blocks are multiples of 128, so a 128-row query tile and a
//   128-key tile each lie in one quantization block.
// - PV is wgmma m64n{d}k16 with P as the A operand straight from registers
//   (the S accumulator layout, f32 or s32, is the A fragment layout, packed
//   to bf16) and V as the B operand in shared memory, read d-major through
//   wgmma's transpose bit: nothing transposes V, and no scalar loads remain.
// - K8: PV is wgmma m64n{d}k32 .s32.s8.s8 too. V8 arrives K-major (keys
//   contiguous per channel) and loads by TMA as d rows of the tile's 128
//   key bytes under the 128-byte swizzle. P is rounded to int8 against the
//   running max (its softmax, k8_softmax, computes 127 P with the logit
//   scale in the exponent's FFMA and keeps its conversions off the
//   quarter-rate pipes: the int8 rounding is then one add) and packed from
//   the S accumulators straight into the s8 A fragment: a thread holds keys
//   2q, 2q + 1 of each 8 where the fragment wants keys 4q .. 4q + 3 of each
//   16, so V's keys are stored permuted within each 16 (0, 1, 8, 9, 2, 3,
//   10, 11, 4, 5, 12, 13, 6, 7, 14, 15: position 4q + i holds key 2q + i % 2
//   + 8 (i / 2)) by the copy that transposes V (``pack_v8``), and the
//   contraction, which does not care about key order, pairs them up. Each
//   tile's int32 sums start fresh (128 keys x 127^2 < 2^22: exact in f32)
//   and are added to the f32 output before its alpha rescale; the output is
//   scaled by sv per channel once, at the store (the denominator sums 127
//   P). Its running max is over 128-key tiles where the reference's is over
//   1,536-key blocks, so P rounds at other maxima: the two agree to the
//   int8 gate, not bit for bit.
// - Each warpgroup issues tile t's QK^T and then tile t-1's PV, waits for
//   the QK^T only, and runs tile t's softmax while that PV is on the tensor
//   cores; the output is rescaled and the new P packed once the PV is done.
//
// Tensors are addressed by element strides (batch, token, head), so the
// wrappers pass [B, N, h, d] views and folded [B*h, N, d] buffers alike
// without copies. Each entry point returns cudaGetLastError().

#include <climits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// K8: an int32 below 2^22 in magnitude as an exact f32 on the full-rate
// pipes (its bits added to those of 1.5 * 2^23, which is then subtracted),
// in place of the quarter-rate I2F.
__device__ __forceinline__ float i22_to_f32(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.f;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- K2, K1 and K8 on wgmma and TMA ----------------------------------------

constexpr int kK2K = 128;        // keys per tile
constexpr int kK2Stages = 3;
constexpr int kK2Slab = 32;      // columns of a slab: 64 bytes, 64-byte swizzle
// with two consumer warpgroups, registers a thread after the hand-over: the
// producer warpgroup keeps 24, each consumer takes 240 (2 x 128 x 240 +
// 128 x 24 = 384 x 168, the pool of a block launched with 168 a thread)
constexpr int kK2ProducerRegs = 24, kK2ConsumerRegs = 240, kK2LaunchRegs = 168;

// two consumer warpgroups of 64 query rows each, and a producer warpgroup.
// kI8 (K1, K8): Q and K tiles are int8 rows of D bytes; otherwise (K2) bf16
// slabs. V is a bf16 slab tile, or with kV8 (K8) D int8 channel rows of the
// tile's 128 keys under the 128-byte swizzle.
template <int D, bool kI8, bool kV8 = false>
struct K2Smem {
  static constexpr int kRows = 128;                   // query rows a block
  static constexpr int kThreads = 384;
  static constexpr int kSlabQ = kRows * kK2Slab * 2;  // bytes of a Q slab
  static constexpr int kSlabKV = kK2K * kK2Slab * 2;
  static constexpr int kQ = kI8 ? kRows * D : (D / kK2Slab) * kSlabQ;
  static constexpr int kK = kI8 ? kK2K * D : (D / kK2Slab) * kSlabKV;
  static constexpr int kV = kV8 ? D * kK2K : (D / kK2Slab) * kSlabKV;
  static constexpr int kStage = kK + kV;
  static constexpr int kSmem = kQ + kK2Stages * kStage + 1024 + 64;
};

// Scale to base 2, mask keys >= kvalid, and run the online softmax over one
// 64 x 128 logit tile (rows g: s[4j], s[4j+1]; rows g+8: s[4j+2], s[4j+3]):
// s becomes P (f32), m and l are updated, and alpha[r] is the factor the
// output rows must be rescaled by.
__device__ __forceinline__ void k2_softmax(float (&s)[kK2K / 2], int kvalid,
                                           int q, float scale_log2,
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kK2K / 8; ++j) {
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
  for (int j = 0; j < kK2K / 8; ++j) {
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

// K8's online softmax over one 64 x 128 tile of int32 logits si (rows g:
// si[4j], si[4j+1]; rows g+8: si[4j+2], si[4j+3]), exact as f32 and scaled
// to base 2 by sc > 0: the running max m (scaled) and, into s, e = 127 *
// 2^(s sc - m), the reference's p times the int8 scale 127, so that P8 is
// e rounded to an integer (adding 2^23 leaves it in the low byte); the
// scale goes into the exponent's FFMA (log2 127 - m), keys >= kvalid are
// masked on a ragged tile only, l sums the e (127 times the reference's
// denominator, which the output's dequantization by sv, not sv / 127,
// absorbs), and alpha[r] is the output rows' rescale.
__device__ __forceinline__ void k8_softmax(const int (&si)[kK2K / 2],
                                           float (&s)[kK2K / 2], int kvalid,
                                           int q, float sc, float (&m)[2],
                                           float (&l)[2], float (&alpha)[2]) {
  constexpr float kLog2_127 = 6.988684686772166f;
  const bool ragged = kvalid < kK2K;
  int mx[2] = {INT_MIN, INT_MIN};
#pragma unroll
  for (int j = 0; j < kK2K / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!ragged || j * 8 + 2 * q + (e & 1) < kvalid)
        mx[e / 2] = max(mx[e / 2], si[4 * j + e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // every tile holds at least one real key, so mx is an int32 logit here
  float c[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], i22_to_f32(mx[r]) * sc);
    alpha[r] = ex2_approx(m[r] - m_new);
    m[r] = m_new;
    c[r] = kLog2_127 - m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kK2K / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = ex2_approx(fmaf(i22_to_f32(si[4 * j + e]), sc, c[e / 2]));
      if (ragged && j * 8 + 2 * q + (e & 1) >= kvalid) v = 0.f;
      s[4 * j + e] = v;
      sum[e / 2] += v;
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// kLse: store the rows' log-sum-exp too. kI8: K1 (int8 Q and K with per-block
// scales qscale, kscale [B*H, nb]; `block` rows a scale). kV8 (with kI8):
// K8, V int8 with per-channel scales vscale [B*H, D] and PV on s8 wgmma.
// Compile-time switches, so that each instantiation carries nothing of the
// others.
// Persistent: each block walks the work items (batch*head, query tile)
// blockIdx.x, + gridDim.x, ...; the ring runs on across items, and the next
// item's Q is loaded as soon as the last QK^T of the current one is done,
// beside its last PV and its stores.
template <int D, bool kLse, bool kI8, bool kV8>
__global__ void __launch_bounds__(K2Smem<D, kI8, kV8>::kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 const float* __restrict__ qscale,
                 const float* __restrict__ kscale, int H, int nq, int nk,
                 int q_tiles, int n_items, int block, int nb, Strides so,
                 float scale_log2, const float* __restrict__ vscale) {
  static_assert(kI8 || !kV8, "K8 is K1's kernel with an int8 V");
  using S = K2Smem<D, kI8, kV8>;
  constexpr int kSlabs = D / kK2Slab;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* skv = sq + S::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + kK2Stages * S::kStage);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + kK2Stages;

  const int n_tiles = (nk + kK2K - 1) / kK2K;
  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    hop::mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < kK2Stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: per item Q, then K and V tiles through the ring ----
    hop::setmaxnreg_dec<kK2ProducerRegs>();
    if (threadIdx.x == 256) {
      hop::prefetch_map(&tmq);
      hop::prefetch_map(&tmk);
      hop::prefetch_map(&tmv);
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int bh = item / q_tiles, b = bh / H, h = bh % H;
        const int q0 = item % q_tiles * S::kRows;
        hop::mbar_wait(q_empty, q_phase ^ 1);
        hop::mbar_expect_tx(q_full, S::kQ);
        if constexpr (kI8) {
          hop::tma_load_4d(sq, &tmq, q_full, 0, h, q0, b);
        } else {
#pragma unroll
          for (int j = 0; j < kSlabs; ++j)
            hop::tma_load_4d(sq + j * S::kSlabQ, &tmq, q_full, j * kK2Slab,
                             h, q0, b);
        }
        q_phase ^= 1;
        for (int t = 0; t < n_tiles; ++t) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sk = skv + stage * S::kStage;
          hop::mbar_expect_tx(&full[stage], S::kStage);
          if constexpr (kI8)
            hop::tma_load_4d(sk, &tmk, &full[stage], 0, h, t * kK2K, b);
          if constexpr (kV8)  // D channel rows of the tile's 128 keys
            hop::tma_load_4d(sk + S::kK, &tmv, &full[stage], t * kK2K, 0, h,
                             b);
#pragma unroll
          for (int j = 0; j < kSlabs; ++j) {
            if constexpr (!kI8)
              hop::tma_load_4d(sk + j * S::kSlabKV, &tmk, &full[stage],
                               j * kK2Slab, h, t * kK2K, b);
            if constexpr (!kV8)
              hop::tma_load_4d(sk + S::kK + j * S::kSlabKV, &tmv,
                               &full[stage], j * kK2Slab, h, t * kK2K, b);
          }
          if (++stage == kK2Stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    hop::setmaxnreg_inc<kK2ConsumerRegs>();
    const int lane = threadIdx.x % 32, w = threadIdx.x % 128 / 32;
    const int g = lane / 4, q = lane % 4;
    const uint8_t* q_rows = sq + wg * 64 * (kI8 ? D : kK2Slab * 2);
    float o_acc[D / 2];
    float m[2], l[2], alpha[2];
    float s[kK2K / 2];
    int si[kI8 ? kK2K / 2 : 1];  // K1's and K8's int32 logits
    int pv[kV8 ? D / 2 : 1];     // K8: one tile's int32 P8 V8 sums
    // P as PV's A fragments: bf16 per k16 step, or (K8) int8 per k32 step
    uint32_t pa[kV8 ? kK2K / 32 : kK2K / 16][4];

    // S = Q K^T into s (K2: both K-major under the 64-byte swizzle, one slab
    // per two k16 steps) or into si (K1: int8 rows of D bytes under the
    // D-byte swizzle, a k32 step 32 bytes in)
    auto issue_s = [&](const uint8_t* sk) {
      hop::wgmma_fence();
      if constexpr (kI8) {
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          hop::WgmmaS8<kK2K>::ss(
              si, hop::make_desc(q_rows + kk * 32, D, 16, 8 * D),
              hop::make_desc(sk + kk * 32, D, 16, 8 * D), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk % 2) * 32;  // bytes into the slab's rows
          hop::Wgmma<kK2K>::ss(
              s,
              hop::make_desc(q_rows + (kk / 2) * S::kSlabQ + off, 64, 16,
                             512),
              hop::make_desc(sk + (kk / 2) * S::kSlabKV + off, 64, 16, 512),
              kk > 0);
        }
      }
      hop::wgmma_commit();
    };
    // the logits of a finished QK^T as f32 in s (K1: converted, exactly;
    // K8 converts them in its softmax)
    auto take_s = [&]() {
      if constexpr (kV8) {
        hop::fence_regs(si);
      } else if constexpr (kI8) {
        hop::fence_regs(si);
#pragma unroll
        for (int i = 0; i < kK2K / 2; ++i) s[i] = static_cast<float>(si[i]);
      } else {
        hop::fence_regs(s);
      }
    };

    // O += P V: P from registers (the S accumulator layout is the A
    // fragment layout), V d-major in shared memory read with the transpose
    // bit; 16 keys are 2 groups of 8 rows (SBO 512), d/32 slabs (LBO)
    // K8: fresh int32 sums each tile, P8 as the s8 A operand from registers
    // and V8 K-major (keys contiguous per channel) as the B operand; a k32
    // step is 32 bytes into the 128-byte rows
    auto issue_pv = [&](const uint8_t* sv) {
      hop::wgmma_fence();
      if constexpr (kV8) {
#pragma unroll
        for (int kk = 0; kk < kK2K / 32; ++kk)
          hop::WgmmaS8<D>::rs(pv, pa[kk],
                              hop::make_desc(sv + kk * 32, 128, 16, 1024),
                              kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < kK2K / 16; ++kk)
          hop::Wgmma<D>::rs_t(o_acc, pa[kk],
                              hop::make_desc(sv + kk * 1024, 64, S::kSlabKV,
                                             512),
                              1);
      }
      hop::wgmma_commit();
    };
    auto pack_p = [&]() {
      if constexpr (kV8) {
        // P rounded to int8 against the running max. The s8 A fragment of
        // a k32 step wants keys 4q..4q+3 (registers 0, 1: rows g, g + 8)
        // and 16 + 4q.. (2, 3) where the accumulators hold keys 2q, 2q + 1
        // of each 8: V's keys are stored permuted within each 16 (position
        // 4q + i holds key 2q + i % 2 + 8 (i / 2), ``pack_v8``), so byte i
        // of a register takes accumulator column block 2 (r / 2) + i / 2,
        // element i % 2 of its row.
        auto byte = [](float e) {  // round(e) in the low byte
          return __float_as_uint(__fadd_rn(e, 8388608.f));
        };
#pragma unroll
        for (int kk = 0; kk < kK2K / 32; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* a = s + 4 * (4 * kk + 2 * (r / 2));
            const int e = 2 * (r % 2);
            pa[kk][r] = __byte_perm(
                __byte_perm(byte(a[e]), byte(a[e + 1]), 0x0040),
                __byte_perm(byte(a[4 + e]), byte(a[5 + e]), 0x0040), 0x5410);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kK2K / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      }
    };
    auto next_stage = [&](int& stage, uint32_t& phase) {
      if (++stage == kK2Stages) {
        stage = 0;
        phase ^= 1;
      }
    };

    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int bh = item / q_tiles, b = bh / H, h = bh % H;
      const int q0 = item % q_tiles * S::kRows;
      // the logit scale of key tile t (base 2); K1: sq * sk * sm_scale,
      // one query block and one key block a tile
      const float q_scale =
          kI8 ? qscale[bh * nb + q0 / block] * scale_log2 : scale_log2;
      auto tile_scale = [&](int t) {
        return kI8 ? q_scale * kscale[bh * nb + t * kK2K / block] : q_scale;
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
      m[0] = m[1] = neg_inf();
      l[0] = l[1] = 0.f;

      hop::mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      hop::mbar_wait(&full[stage], phase);
      issue_s(skv + stage * S::kStage);
      hop::wgmma_wait<0>();
      take_s();
      if (n_tiles == 1 && lane == 0) hop::mbar_arrive(q_empty);
      if constexpr (kV8)
        k8_softmax(si, s, nk, q, tile_scale(0), m, l, alpha);
      else
        k2_softmax(s, nk, q, tile_scale(0), m, l, alpha);
      pack_p();
      int prev = stage;
      next_stage(stage, phase);
      // tile t's QK^T runs on the tensor cores beside tile t-1's PV, and
      // t's softmax overlaps that PV
      for (int t = 1; t < n_tiles; ++t) {
        hop::mbar_wait(&full[stage], phase);
        issue_s(skv + stage * S::kStage);
        issue_pv(skv + prev * S::kStage + S::kK);
        hop::wgmma_wait<1>();  // S of tile t is done, t-1's PV may run on
        take_s();
        if (t == n_tiles - 1 && lane == 0) hop::mbar_arrive(q_empty);
        if constexpr (kV8)
          k8_softmax(si, s, nk - t * kK2K, q, tile_scale(t), m, l, alpha);
        else
          k2_softmax(s, nk - t * kK2K, q, tile_scale(t), m, l, alpha);
        hop::wgmma_wait<0>();
        hop::fence_regs(o_acc);
        hop::fence_regs(pa);
        if (lane == 0) hop::mbar_arrive(&empty[prev]);
        if constexpr (kV8) {
          // o = (o + the finished tile's P8 V8) * alpha
          hop::fence_regs(pv);
#pragma unroll
          for (int j = 0; j < D / 2; ++j)
            o_acc[j] = (o_acc[j] + i22_to_f32(pv[j])) * alpha[j % 4 / 2];
        } else {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o_acc[4 * j] *= alpha[0];
            o_acc[4 * j + 1] *= alpha[0];
            o_acc[4 * j + 2] *= alpha[1];
            o_acc[4 * j + 3] *= alpha[1];
          }
        }
        pack_p();
        prev = stage;
        next_stage(stage, phase);
      }
      issue_pv(skv + prev * S::kStage + S::kK);
      hop::wgmma_wait<0>();
      hop::fence_regs(o_acc);
      if (lane == 0) hop::mbar_arrive(&empty[prev]);
      if constexpr (kV8) {
        hop::fence_regs(pv);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o_acc[j] += i22_to_f32(pv[j]);
      }

      // ---- normalise and store rows < nq (and their log-sum-exp) ----
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv0 = 1.f / fmaxf(l[0], 1e-37f);
      const float inv1 = 1.f / fmaxf(l[1], 1e-37f);
      const int ra = q0 + wg * 64 + w * 16 + g, rb = ra + 8;
      if constexpr (kLse) {
        float* lse_row = lse + (long long)bh * nq;
        if (q == 0) {
          if (ra < nq)
            lse_row[ra] = (m[0] + log2f(fmaxf(l[0], 1e-37f))) * kLn2;
          if (rb < nq)
            lse_row[rb] = (m[1] + log2f(fmaxf(l[1], 1e-37f))) * kLn2;
        }
      }
      __nv_bfloat16* ob = o + b * so.b + h * so.h;
      if constexpr (kV8) {
        // the int32 sums dequantized by sv per channel (the 1 / 127 of P8
        // is in l)
#pragma unroll
        for (int j = 0; j < D / 2; ++j)
          o_acc[j] *= vscale[bh * D + j / 4 * 8 + 2 * q + j % 2];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + 2 * q;
        if (ra < nq)
          *reinterpret_cast<uint32_t*>(ob + ra * so.n + c) =
              pack_bf16(o_acc[4 * j] * inv0, o_acc[4 * j + 1] * inv0);
        if (rb < nq)
          *reinterpret_cast<uint32_t*>(ob + rb * so.n + c) =
              pack_bf16(o_acc[4 * j + 2] * inv1, o_acc[4 * j + 3] * inv1);
      }
    }
  }
}

template <int D, bool kLse, bool kI8, bool kV8 = false>
cudaError_t launch_k(int blocks, cudaStream_t st, const CUtensorMap& tq,
                     const CUtensorMap& tk, const CUtensorMap& tv,
                     __nv_bfloat16* o, float* lse, const float* qscale,
                     const float* kscale, int H, int nq, int nk, int q_tiles,
                     int n_items, int block, int nb, Strides so,
                     float scale_log2, const float* vscale = nullptr) {
  using S = K2Smem<D, kI8, kV8>;
  static cudaError_t attr =
      hop_host::allow_smem(flash_kernel<D, kLse, kI8, kV8>, S::kSmem);
  if (attr != cudaSuccess) return attr;
  // the consumers' setmaxnreg.inc needs the pool of a 168-register launch
  static const int regs = [] {
    cudaFuncAttributes fa;
    return cudaFuncGetAttributes(&fa, flash_kernel<D, kLse, kI8, kV8>) ==
                   cudaSuccess
               ? fa.numRegs
               : 0;
  }();
  if (regs < kK2LaunchRegs) return cudaErrorInvalidConfiguration;
  flash_kernel<D, kLse, kI8, kV8><<<blocks, S::kThreads, S::kSmem, st>>>(
      tq, tk, tv, o, lse, qscale, kscale, H, nq, nk, q_tiles, n_items, block,
      nb, so, scale_log2, vscale);
  return cudaGetLastError();
}

// Work items of 128 query rows for every (batch, head); one block per SM,
// or fewer when the items are fewer. False when they overflow an int.
bool plan_items(int B, int H, int nq, int* q_tiles, int* n_items,
                int* blocks) {
  *q_tiles = (nq + 127) / 128;
  const long long items = (long long)*q_tiles * B * H;
  if (items >= (1LL << 31)) return false;
  *n_items = static_cast<int>(items);
  const int sms = hop_host::sm_count();
  *blocks = *n_items < sms ? *n_items : sms;
  return true;
}

template <int D>
cudaError_t launch_bf16(cudaStream_t st, const void* q, const void* k,
                        const void* v, __nv_bfloat16* o, float* lse, int B,
                        int H, int nq, int nk, Strides sq, Strides sk,
                        Strides sv, Strides so, float scale_log2) {
  constexpr int rows = K2Smem<D, false>::kRows;
  CUtensorMap tq, tk, tv;
  int q_tiles, n_items, blocks;
  if (!bnhd_map(&tq, q, B, nq, H, D, sq, rows) ||
      !bnhd_map(&tk, k, B, nk, H, D, sk, kK2K) ||
      !bnhd_map(&tv, v, B, nk, H, D, sv, kK2K) ||
      !plan_items(B, H, nq, &q_tiles, &n_items, &blocks))
    return cudaErrorInvalidValue;
  if (lse != nullptr)
    return launch_k<D, true, false>(blocks, st, tq, tk, tv, o, lse, nullptr,
                                    nullptr, H, nq, nk, q_tiles, n_items, 1,
                                    0, so, scale_log2);
  return launch_k<D, false, false>(blocks, st, tq, tk, tv, o, lse, nullptr,
                                   nullptr, H, nq, nk, q_tiles, n_items, 1, 0,
                                   so, scale_log2);
}

// K1: q8, k8 int8 rows of D bytes (maps of whole rows under the D-byte
// swizzle), v bf16 as K2 takes it.
template <int D>
cudaError_t launch_int8qk(cudaStream_t st, const void* q8, const void* k8,
                          const void* v, __nv_bfloat16* o,
                          const float* qscale, const float* kscale, int B,
                          int H, int n, int block, int nb, Strides sq,
                          Strides sk, Strides sv, Strides so,
                          float scale_log2) {
  constexpr int rows = K2Smem<D, true>::kRows;
  CUtensorMap tq, tk, tv;
  int q_tiles, n_items, blocks;
  if (!bnhd_map(&tq, q8, B, n, H, D, sq, rows, D, 1, D,
                CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !bnhd_map(&tk, k8, B, n, H, D, sk, kK2K, D, 1, D,
                CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !bnhd_map(&tv, v, B, n, H, D, sv, kK2K) ||
      !plan_items(B, H, n, &q_tiles, &n_items, &blocks))
    return cudaErrorInvalidValue;
  return launch_k<D, false, true>(blocks, st, tq, tk, tv, o, nullptr, qscale,
                                  kscale, H, n, n, q_tiles, n_items, block,
                                  nb, so, scale_log2);
}

// K8: q8, k8 int8 rows as K1 takes them; V int8, transposed with its keys
// permuted within each 16 (``pack_v8``), vt [B*H, D, npad] addressed by sv
// (batch and head strides, and the byte pitch of a channel row, npad, in
// sv.n), mapped as D channel rows of 128 keys (128 bytes) under the
// 128-byte swizzle; the f32 per-(batch*head, channel) scales vscale
// [B*H, D].
template <int D>
cudaError_t launch_int8qkv(cudaStream_t st, const void* q8, const void* k8,
                           const void* vt, __nv_bfloat16* o,
                           const float* qscale, const float* kscale,
                           const float* vscale, int B, int H, int n,
                           int block, int nb, Strides sq, Strides sk,
                           Strides sv, Strides so, float scale_log2) {
  constexpr int rows = K2Smem<D, true, true>::kRows;
  const uint64_t dims[4] = {(uint64_t)sv.n, (uint64_t)D, (uint64_t)H,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sv.n, (uint64_t)sv.h,
                               (uint64_t)sv.b};
  const uint32_t box[4] = {(uint32_t)kK2K, (uint32_t)D, 1, 1};
  CUtensorMap tq, tk, tv;
  int q_tiles, n_items, blocks;
  if (!bnhd_map(&tq, q8, B, n, H, D, sq, rows, D, 1, D,
                CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !bnhd_map(&tk, k8, B, n, H, D, sk, kK2K, D, 1, D,
                CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !hop_host::make_map(&tv, vt, 4, dims, strides, box, 128,
                          CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !plan_items(B, H, n, &q_tiles, &n_items, &blocks))
    return cudaErrorInvalidValue;
  return launch_k<D, false, true, true>(blocks, st, tq, tk, tv, o, nullptr,
                                        qscale, kscale, H, n, n, q_tiles,
                                        n_items, block, nb, so, scale_log2,
                                        vscale);
}

}  // namespace

extern "C" {

// `lse`: f32 [B, H, nq] to receive the rows' log-sum-exp, or null.
int flash_attn_bf16(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int H, int nq, int nk, int d,
                    long long q_sb,
                    long long q_sn, long long q_sh, long long k_sb,
                    long long k_sn, long long k_sh, long long v_sb,
                    long long v_sn, long long v_sh, long long o_sb,
                    long long o_sn, long long o_sh, float sm_scale,
                    void* stream) {
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto op = static_cast<__nv_bfloat16*>(o);
  auto lp = static_cast<float*>(lse);
  cudaError_t e;
  if (d == 128)
    e = launch_bf16<128>(st, q, k, v, op, lp, B, H, nq, nk, sq, sk, sv, so,
                         scale_log2);
  else if (d == 96)
    e = launch_bf16<96>(st, q, k, v, op, lp, B, H, nq, nk, sq, sk, sv, so,
                        scale_log2);
  else if (d == 64)
    e = launch_bf16<64>(st, q, k, v, op, lp, B, H, nq, nk, sq, sk, sv, so,
                        scale_log2);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// q8, k8: int8, addressed by element strides (the folded [B*H, Npad, d]
// buffers); v, o: bf16 [B, n, H, d] views; qscale, kscale: f32 [B*H, nb], one
// scale per `block` rows (a multiple of 128).
int flash_attn_int8qk(const void* q8, const void* k8, const void* v, void* o,
                      const void* qscale, const void* kscale, int B, int H,
                      int n, int d, int block, int nb, long long q_sb,
                      long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
                      long long v_sb, long long v_sn, long long v_sh,
                      long long o_sb, long long o_sn, long long o_sh,
                      float sm_scale, void* stream) {
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto op = static_cast<__nv_bfloat16*>(o);
  auto qs = static_cast<const float*>(qscale);
  auto ks = static_cast<const float*>(kscale);
  if (block % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (d == 128)
    e = launch_int8qk<128>(st, q8, k8, v, op, qs, ks, B, H, n, block, nb, sq,
                           sk, sv, so, scale_log2);
  else if (d == 64)
    e = launch_int8qk<64>(st, q8, k8, v, op, qs, ks, B, H, n, block, nb, sq,
                          sk, sv, so, scale_log2);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// vt: int8 [B*H, d, Npad], V transposed with its keys permuted within each
// 16 (``pack_v8``); vscale: f32 [B*H, d]; v_sb, v_sh and v_sn are its
// element strides between batches, heads and channel rows (v_sn = Npad).
int flash_attn_int8qkv(const void* q8, const void* k8, const void* vt,
                       void* o, const void* qscale, const void* kscale,
                       const void* vscale, int B, int H, int n, int d,
                       int block, int nb, long long q_sb, long long q_sn,
                       long long q_sh, long long k_sb, long long k_sn,
                       long long k_sh, long long v_sb, long long v_sn,
                       long long v_sh, long long o_sb, long long o_sn,
                       long long o_sh, float sm_scale, void* stream) {
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto op = static_cast<__nv_bfloat16*>(o);
  auto qs = static_cast<const float*>(qscale);
  auto ks = static_cast<const float*>(kscale);
  auto vs = static_cast<const float*>(vscale);
  if (block % 128 != 0 || v_sn % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (d == 128)
    e = launch_int8qkv<128>(st, q8, k8, vt, op, qs, ks, vs, B, H, n, block,
                            nb, sq, sk, sv, so, scale_log2);
  else if (d == 64)
    e = launch_int8qkv<64>(st, q8, k8, vt, op, qs, ks, vs, B, H, n, block,
                           nb, sq, sk, sv, so, scale_log2);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
