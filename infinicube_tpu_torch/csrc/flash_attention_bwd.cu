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
// What bounds it: 10*Nq*Nk*d operations per (batch, head) (S, dP, dV, dK, dQ)
// against (3 inputs + dO + 3 outputs)*N*d*2 bytes: tensor-core bound.
//
// Design (a first, simple version): two kernels like the library's, so no
// atomics and a deterministic result. The dK/dV kernel gives each block of 4
// warps one tile of 64 keys (16 per warp) and loops over the tiles of 64
// queries; the dQ kernel gives each block one tile of 64 queries and loops
// over the key tiles. Both stage their four 64 x d tiles (Q, dO, K, V) in
// shared memory, compute the 16 x 64 logit and dP tiles of each warp with
// mma.sync m16n8k16 (the A rows from the block's own tile, the B rows from
// the streamed tile), turn them into P and dS in registers, and feed those
// straight into the A operand of the second products, whose B operand (the
// streamed tile, read across its rows) comes through ldmatrix.trans. The
// dK/dV kernel computes the transposed tiles S^T and dP^T (keys as rows), so
// that dV and dK accumulate per key row in registers; its per-query lse and
// D sit in shared memory, the dQ kernel's per-row ones in registers. No TMA,
// wgmma or load pipelining yet.
//
// Tensors are addressed by element strides (batch, token, head) as in K2.
// The entry point returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[j] += A[16 x D] * B[64 x D]^T for the 8 column blocks j of 8: `a` points
// at the warp's 16 rows, `b` at the 64 rows of the other tile (both [.][LD]
// bf16 in shared memory).
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[kBK / 8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int g, int t) {
  constexpr int LD = D + 8;
  const __nv_bfloat16* ar = a + g * LD + 2 * t;
  const __nv_bfloat16* br = b + g * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    af[0] = ld32(ar + kk * 16);
    af[1] = ld32(ar + 8 * LD + kk * 16);
    af[2] = ld32(ar + kk * 16 + 8);
    af[3] = ld32(ar + 8 * LD + kk * 16 + 8);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      mma_bf16(c[j], af, ld32(br + j * 8 * LD + kk * 16),
               ld32(br + j * 8 * LD + kk * 16 + 8));
  }
}

// acc[16 x D] += P[16 x 64] * B[64 x D]: P as packed bf16 A operands (four
// chunks of 16 columns), B the 64 rows of a tile in shared memory, read
// transposed with ldmatrix (two 8-wide column blocks of D per instruction).
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const uint32_t (&pa)[kBK / 16][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
  const __nv_bfloat16* br = b + (lane % 16) * LD + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, br + kk * 16 * LD + j * 8);
      mma_bf16(acc[j], pa[kk], r[0], r[1]);
      mma_bf16(acc[j + 1], pa[kk], r[2], r[3]);
    }
  }
}

// accumulator tile (column blocks of 8) -> bf16 A operands (chunks of 16)
__device__ __forceinline__ void pack_a(uint32_t (&pa)[kBK / 16][4],
                                       const float (&s)[kBK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// Store the warp's 16 x D accumulator times `scale` as bf16 rows, rows >=
// nrows skipped.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* ob, Strides so,
                                          int row0, int nrows, int g, int t,
                                          const float (&o)[D / 8][4],
                                          float scale) {
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (ra < nrows)
      *reinterpret_cast<uint32_t*>(ob + ra * so.n + c) =
          pack_bf16(o[j][0] * scale, o[j][1] * scale);
    if (rb < nrows)
      *reinterpret_cast<uint32_t*>(ob + rb * so.n + c) =
          pack_bf16(o[j][2] * scale, o[j][3] * scale);
  }
}

template <int D>
constexpr int bwd_smem_bytes() {
  return 4 * 64 * (D + 8) * 2 + 2 * 64 * 4;
}

// One block per (batch*head, tile of 64 keys): dK and dV of its keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int nq, int nk,
                         Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides sdk, Strides sdv, float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + 64 * LD;
  __nv_bfloat16* sQ = sV + 64 * LD;
  __nv_bfloat16* sDO = sQ + 64 * LD;
  float* sLse = reinterpret_cast<float*>(sDO + 64 * LD);  // base 2
  float* sDelta = sLse + 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBK;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
  const float scale_log2 = sm_scale * kLog2e;

  load_tile(reinterpret_cast<unsigned char*>(sK), LD * 2,
            reinterpret_cast<const unsigned char*>(k + b * sk.b + h * sk.h +
                                                   k0 * sk.n),
            sk.n * 2, kBK, D * 2, nk - k0);
  load_tile(reinterpret_cast<unsigned char*>(sV), LD * 2,
            reinterpret_cast<const unsigned char*>(v + b * sv.b + h * sv.h +
                                                   k0 * sv.n),
            sv.n * 2, kBK, D * 2, nk - k0);
  // this thread's two key rows; a key >= nk gives P = 0
  const bool ka_ok = k0 + warp * 16 + g < nk;
  const bool kb_ok = k0 + warp * 16 + g + 8 < nk;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int q0 = 0; q0 < nq; q0 += kBQ) {
    __syncthreads();  // previous query tile consumed
    load_tile(reinterpret_cast<unsigned char*>(sQ), LD * 2,
              reinterpret_cast<const unsigned char*>(qb + q0 * sq.n),
              sq.n * 2, kBQ, D * 2, nq - q0);
    load_tile(reinterpret_cast<unsigned char*>(sDO), LD * 2,
              reinterpret_cast<const unsigned char*>(dob + q0 * sdo.n),
              sdo.n * 2, kBQ, D * 2, nq - q0);
    {
      // a query >= nq gets lse = +inf, so its P is 0
      const int i = threadIdx.x % 64, r = q0 + i;
      if (threadIdx.x < 64)
        sLse[i] = r < nq ? lse[(long long)bh * nq + r] * kLog2e
                         : __int_as_float(0x7f800000);
      else
        sDelta[i] = r < nq ? delta[(long long)bh * nq + r] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T: rows are this warp's keys, columns the tile's queries
    float s[kBQ / 8][4], dp[kBQ / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D>(s, sK + warp * 16 * LD, sQ, g, t);
    mma_abt<D>(dp, sV + warp * 16 * LD, sDO, g, t);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const bool ok = (e < 2) ? ka_ok : kb_ok;
        const float p = ok ? exp2f(s[j][e] * scale_log2 - sLse[col]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sDelta[col]);
      }
    }
    uint32_t pa[kBQ / 16][4];
    pack_a(pa, s);
    mma_pb<D>(dv_acc, pa, sDO, lane);   // dV += P^T dO
    pack_a(pa, dp);
    mma_pb<D>(dk_acc, pa, sQ, lane);    // dK += dS^T Q
  }
  store_acc<D>(dk + b * sdk.b + h * sdk.h, sdk, k0 + warp * 16, nk, g, t,
               dk_acc, sm_scale);
  store_acc<D>(dv + b * sdv.b + h * sdv.h, sdv, k0 + warp * 16, nk, g, t,
               dv_acc, 1.f);
}

// One block per (batch*head, tile of 64 queries): dQ of its rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int nq, int nk,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + 64 * LD;
  __nv_bfloat16* sQ = sV + 64 * LD;
  __nv_bfloat16* sDO = sQ + 64 * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const float scale_log2 = sm_scale * kLog2e;

  load_tile(reinterpret_cast<unsigned char*>(sQ), LD * 2,
            reinterpret_cast<const unsigned char*>(q + b * sq.b + h * sq.h +
                                                   q0 * sq.n),
            sq.n * 2, kBQ, D * 2, nq - q0);
  load_tile(reinterpret_cast<unsigned char*>(sDO), LD * 2,
            reinterpret_cast<const unsigned char*>(dout + b * sdo.b +
                                                   h * sdo.h + q0 * sdo.n),
            sdo.n * 2, kBQ, D * 2, nq - q0);
  // this thread's two query rows; a row >= nq gets lse = +inf, so P = 0
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < nq ? lse[(long long)bh * nq + row] * kLog2e
                       : __int_as_float(0x7f800000);
    dl[r] = row < nq ? delta[(long long)bh * nq + row] : 0.f;
  }
  float dq_acc[D / 8][4];
  zero(dq_acc);

  for (int k0 = 0; k0 < nk; k0 += kBK) {
    __syncthreads();  // previous key tile consumed
    load_tile(reinterpret_cast<unsigned char*>(sK), LD * 2,
              reinterpret_cast<const unsigned char*>(kb + k0 * sk.n),
              sk.n * 2, kBK, D * 2, nk - k0);
    load_tile(reinterpret_cast<unsigned char*>(sV), LD * 2,
              reinterpret_cast<const unsigned char*>(vb + k0 * sv.n),
              sv.n * 2, kBK, D * 2, nk - k0);
    __syncthreads();
    float s[kBK / 8][4], dp[kBK / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D>(s, sQ + warp * 16 * LD, sK, g, t);
    mma_abt<D>(dp, sDO + warp * 16 * LD, sV, g, t);
    const int kvalid = nk - k0;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p =
            col < kvalid ? exp2f(s[j][e] * scale_log2 - lse2[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }
    }
    uint32_t pa[kBK / 16][4];
    pack_a(pa, dp);
    mma_pb<D>(dq_acc, pa, sK, lane);    // dQ += dS K
  }
  store_acc<D>(dq + b * sdq.b + h * sdq.h, sdq, q0 + warp * 16, nq, g, t,
               dq_acc, sm_scale);
}

template <int D>
cudaError_t launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* dout,
                       const float* lse, const float* delta,
                       __nv_bfloat16* dq, __nv_bfloat16* dk,
                       __nv_bfloat16* dv, int B, int H, int nq, int nk,
                       Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdq, Strides sdk, Strides sdv, float sm_scale,
                       cudaStream_t st) {
  constexpr int smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D>
      <<<dim3((nk + kBK - 1) / kBK, B * H), kThreads, smem, st>>>(
          q, k, v, dout, lse, delta, dk, dv, H, nq, nk, sq, sk, sv, sdo, sdk,
          sdv, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D>
      <<<dim3((nq + kBQ - 1) / kBQ, B * H), kThreads, smem, st>>>(
          q, k, v, dout, lse, delta, dq, H, nq, nk, sq, sk, sv, sdo, sdq,
          sm_scale);
  return cudaGetLastError();
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
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const __nv_bfloat16*>(k);
  auto vp = static_cast<const __nv_bfloat16*>(v);
  auto dop = static_cast<const __nv_bfloat16*>(dout);
  auto lp = static_cast<const float*>(lse);
  auto dlp = static_cast<const float*>(delta);
  auto dqp = static_cast<__nv_bfloat16*>(dq);
  auto dkp = static_cast<__nv_bfloat16*>(dk);
  auto dvp = static_cast<__nv_bfloat16*>(dv);
  cudaError_t err;
  if (d == 128)
    err = launch_bwd<128>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, nq,
                          nk, sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else if (d == 96)
    err = launch_bwd<96>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, nq,
                         nk, sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else if (d == 64)
    err = launch_bwd<64>(qp, kp, vp, dop, lp, dlp, dqp, dkp, dvp, B, H, nq,
                         nk, sq, sk, sv, sdo, sdq, sdk, sdv, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
