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
// 64); as f32 work on the CUDA cores (67 TFLOP/s) about 3.2 ms.
//
// Design, simple first: two kernels like the library's, the dK/dV one and
// then the dQ one, so dQ takes no float atomics and two runs are
// bit-identical. They are one template, mirrored:
//   item rows (a block's, kept)        streamed tiles (cp.async, 2 stages)
//   dK/dV: 64 keys of K and V           BT queries of Q and dO
//   dQ:    64 queries of Q and dO       BT keys of K and V
// with BT = 64 at d = 64 and 32 at d = 96 and 128 (registers). A block is
// four warps of 16 item rows. Every product runs on the tensor cores as
// mma.sync m16n8k8 .tf32 by the 3xTF32 split (a = hi + lo, hi the tf32
// truncation of a, lo that of a - hi; lo_A hi_B + hi_A lo_B + hi_A hi_B),
// operands read from shared memory (rows padded to d + 4 floats, so every
// fragment load is free of bank conflicts) and split in registers. For
// each streamed tile a warp computes X = A1 B1^T and Y = A2 B2^T (S^T and
// dP^T, or S and dP), turns them into P and dS in registers, and adds P^T
// dO and dS^T Q (or dS K) into its sums. The tensor cores truncate every
// sum they accumulate, so each tile's product over its BT rows goes into
// sums of its own (32 columns at a time) that are added into the f32 sums
// with a rounded add; the sums never ride a chain of thousands of steps.
// P and dS go from the accumulators straight into the A operand: a
// thread's accumulators hold columns 2t and 2t+1 of each 8 where the A
// fragment wants t and t+4, so the A fragment's k index t stands for row
// 2t of the tile's 8 and t+4 for row 2t+1, and the B fragment is loaded
// from those rows.
//
// Tensors are addressed by element strides (batch, token, head), 16-byte
// aligned. The entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for what it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;      // item rows a block, 16 a warp
constexpr int kThreads = 128;  // four warps

struct Strides {
  long long b, n, h;  // elements between batches, tokens, heads
};

template <int D>
struct BwdCfg {
  static constexpr int kLd = D + 4;               // floats a shared row
  static constexpr int kBt = D == 64 ? 64 : 32;   // rows of a streamed tile
  static constexpr int kItem = kRows * kLd;       // floats of an item tensor
  static constexpr int kTile = kBt * kLd;         // floats of a tile tensor
  static constexpr int kSmem = (2 * kItem + 2 * 2 * kTile) * 4;
};

struct BwdArgs {
  const float* a1;  // item tensors: K, V (dK/dV pass) or Q, dO (dQ pass)
  const float* a2;
  const float* b1;  // streamed: Q, dO or K, V
  const float* b2;
  Strides sa1, sa2, sb1, sb2;
  const float* lse;    // [B*H, nq], natural log
  const float* delta;  // [B*H, nq]
  float* out1;         // dK or dQ (times sm_scale)
  float* out2;         // dV, or null
  Strides so1, so2;
  int H, nq, nk;
  float sm_scale;
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a b on mma.sync m16n8k8 (tf32 in, f32 sums)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to f32 accuracy: the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + rows - 1 of one (batch, head) of a [B, N, H, D] view
// (row r at g + r * sn) into shared rows of D + 4 floats; rows >= n zero
template <int D>
__device__ __forceinline__ void load_rows(float* s, const float* g,
                                          long long sn, int r0, int rows,
                                          int n) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = i % (D / 4) * 4;
    const bool ok = r0 + r < n;
    cp16(s + r * (D + 4) + c, ok ? g + (long long)(r0 + r) * sn + c : g, ok);
  }
}

// kDKV: the dK/dV pass (item rows = keys, tiles = queries); otherwise the
// dQ pass (item rows = queries, tiles = keys). Grid: (item tiles, B*H).
template <int D, bool kDKV>
__global__ void __launch_bounds__(kThreads)
    flash_f32_bwd_kernel(const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int BT = C::kBt, LD = C::kLd;
  extern __shared__ float4 smem4[];
  float* sa1 = reinterpret_cast<float*>(smem4);
  float* sa2 = sa1 + C::kItem;
  float* sb = sa2 + C::kItem;  // stage s: B1 at sb + 2 s kTile, B2 after

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int n_item = kDKV ? a.nk : a.nq, n_rows = kDKV ? a.nq : a.nk;
  const int r0 = blockIdx.x * kRows;
  const int n_tiles = (n_rows + BT - 1) / BT;
  const float* g1 = a.a1 + b * a.sa1.b + h * a.sa1.h;
  const float* g2 = a.a2 + b * a.sa2.b + h * a.sa2.h;
  const float* t1 = a.b1 + b * a.sb1.b + h * a.sb1.h;
  const float* t2 = a.b2 + b * a.sb2.b + h * a.sb2.h;
  load_rows<D>(sa1, g1, a.sa1.n, r0, kRows, n_item);
  load_rows<D>(sa2, g2, a.sa2.n, r0, kRows, n_item);
  load_rows<D>(sb, t1, a.sb1.n, 0, BT, n_rows);
  load_rows<D>(sb + C::kTile, t2, a.sb2.n, 0, BT, n_rows);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;  // this thread's item rows
  const float* lse_row = a.lse + (long long)bh * a.nq;
  const float* d_row = a.delta + (long long)bh * a.nq;
  const float scale_log2 = a.sm_scale * kLog2e;
  // dQ pass: the rows' lse (base 2) and D; rows >= nq are never stored
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if constexpr (!kDKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? rb : ra;
      if (row < a.nq) {
        lse2[r] = lse_row[row] * kLog2e;
        dl[r] = d_row[row];
      }
    }
  }

  float acc1[D / 8][4], acc2[kDKV ? D / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = 0.f;
  if constexpr (kDKV) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[n][e] = 0.f;
  }
  float x[BT / 8][4], y[BT / 8][4];
  const float* A1 = sa1 + warp * 16 * LD;
  const float* A2 = sa2 + warp * 16 * LD;

  // X = A1 B1^T (or Y = A2 B2^T): 16 item rows x BT tile rows over d
  auto product_t = [&](float(&o)[BT / 8][4], const float* A, const float* B) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      const float* ar = A + g * LD + 8 * kk + t4;
      split(ar[0], ah[0], al[0]);
      split(ar[8 * LD], ah[1], al[1]);
      split(ar[4], ah[2], al[2]);
      split(ar[8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float* br = B + (8 * j + g) * LD + 8 * kk + t4;
        mma3(o[j], ah, al, br[0], br[4]);
      }
    }
  };
  // acc += Z B: Z (16 x BT, the accumulators of X or Y) as A fragments,
  // B (BT tile rows x d); each tile's sum is its own, 32 columns at a time
  auto product_n = [&](float(&acc)[D / 8][4], const float(&z)[BT / 8][4],
                       const float* B) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      float f[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BT / 8; ++kk) {
        // k index t is tile row 8 kk + 2 t, t + 4 is row 8 kk + 2 t + 1
        uint32_t ah[4], al[4];
        split(z[kk][0], ah[0], al[0]);
        split(z[kk][2], ah[1], al[1]);
        split(z[kk][1], ah[2], al[2]);
        split(z[kk][3], ah[3], al[3]);
        const float* br = B + (8 * kk + 2 * t4) * LD + 32 * c + g;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma3(f[n], ah, al, br[8 * n], br[LD + 8 * n]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * c + n][e] += f[n][e];
    }
  };

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      float* nb = sb + ((t + 1) & 1) * 2 * C::kTile;
      load_rows<D>(nb, t1, a.sb1.n, (t + 1) * BT, BT, n_rows);
      load_rows<D>(nb + C::kTile, t2, a.sb2.n, (t + 1) * BT, BT, n_rows);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* B1 = sb + (t & 1) * 2 * C::kTile;
    const float* B2 = B1 + C::kTile;
    product_t(x, A1, B1);
    product_t(y, A2, B2);
    // P and dS; columns t BT + 8 j + 2 t4 + (e & 1), rows ra (e < 2), rb
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * BT + 8 * j + 2 * t4 + (e & 1);
        float p, dd;
        if constexpr (kDKV) {
          const bool ok = col < a.nq;
          p = ok ? exp2f(x[j][e] * scale_log2 - lse_row[col] * kLog2e) : 0.f;
          dd = ok ? d_row[col] : 0.f;
        } else {
          p = col < a.nk ? exp2f(x[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
          dd = dl[e >> 1];
        }
        x[j][e] = p;
        y[j][e] = p * (y[j][e] - dd);
      }
    }
    product_n(acc1, y, B1);                 // dK += dS^T Q, or dQ += dS K
    if constexpr (kDKV) product_n(acc2, x, B2);  // dV += P^T dO
    __syncthreads();  // the next prefetch overwrites this stage
  }

  // ---- the item rows < n_item ----
  float* o1 = a.out1 + b * a.so1.b + h * a.so1.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    if (ra < n_item)
      *reinterpret_cast<float2*>(o1 + ra * a.so1.n + c) = make_float2(
          acc1[n][0] * a.sm_scale, acc1[n][1] * a.sm_scale);
    if (rb < n_item)
      *reinterpret_cast<float2*>(o1 + rb * a.so1.n + c) = make_float2(
          acc1[n][2] * a.sm_scale, acc1[n][3] * a.sm_scale);
  }
  if constexpr (kDKV) {
    float* o2 = a.out2 + b * a.so2.b + h * a.so2.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (ra < n_item)
        *reinterpret_cast<float2*>(o2 + ra * a.so2.n + c) =
            make_float2(acc2[n][0], acc2[n][1]);
      if (rb < n_item)
        *reinterpret_cast<float2*>(o2 + rb * a.so2.n + c) =
            make_float2(acc2[n][2], acc2[n][3]);
    }
  }
}

template <int D, bool kDKV>
cudaError_t launch_pass(const BwdArgs& a, int B, cudaStream_t st) {
  using C = BwdCfg<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_bwd_kernel<D, kDKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  const int item_tiles = ((kDKV ? a.nk : a.nq) + kRows - 1) / kRows;
  flash_f32_bwd_kernel<D, kDKV>
      <<<dim3(item_tiles, B * a.H), kThreads, C::kSmem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dq, float* dk, float* dv,
                       int B, int H, int nq, int nk, Strides sq, Strides sk,
                       Strides sv, Strides sdo, Strides sdq, Strides sdk,
                       Strides sdv, float sm_scale, cudaStream_t st) {
  BwdArgs a;
  a.lse = lse;
  a.delta = delta;
  a.H = H;
  a.nq = nq;
  a.nk = nk;
  a.sm_scale = sm_scale;
  // dK, dV: the keys are the item rows
  a.a1 = k;
  a.sa1 = sk;
  a.a2 = v;
  a.sa2 = sv;
  a.b1 = q;
  a.sb1 = sq;
  a.b2 = dout;
  a.sb2 = sdo;
  a.out1 = dk;
  a.so1 = sdk;
  a.out2 = dv;
  a.so2 = sdv;
  cudaError_t e = launch_pass<D, true>(a, B, st);
  if (e != cudaSuccess) return e;
  // dQ: the queries are
  a.a1 = q;
  a.sa1 = sq;
  a.a2 = dout;
  a.sa2 = sdo;
  a.b1 = k;
  a.sb1 = sk;
  a.b2 = v;
  a.sb2 = sv;
  a.out1 = dq;
  a.so1 = sdq;
  a.out2 = nullptr;
  a.so2 = sdq;
  return launch_pass<D, false>(a, B, st);
}

}  // namespace

extern "C" {

// q, dout, dq: f32 [B, nq, H, d]; k, v, dk, dv: f32 [B, nk, H, d], by
// element strides (batch, token, head), 16-byte aligned; lse, delta:
// contiguous f32 [B, H, nq].
int flash_attn_f32_bwd(const void* q, const void* k, const void* v,
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
  if (B <= 0 || H <= 0 || nq <= 0 || nk <= 0 || (long long)B * H > 65535)
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
  cudaError_t e;
  if (d == 128)
    e = launch_bwd<128>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, nq,
                        nk, sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else if (d == 96)
    e = launch_bwd<96>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, nq, nk,
                       sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else if (d == 64)
    e = launch_bwd<64>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, nq, nk,
                       sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
