// Non-causal f32 attention forward for Hopper (sm_90a, though it uses nothing
// Hopper-specific), behind a plain C interface (loaded with ctypes by
// infinicube_tpu_torch/kernels).
//
// flash_attn_f32 replaces the library Pallas TPU flash attention
//   (jax.experimental.pallas.ops.tpu.flash_attention, called at
//   infinicube_tpu/ops/attention.py:72) and the f32 einsum attention beside
//   it (:19-22) for f32 inputs, which the reference serves in the inputs'
//   dtype: an f32 UNet's SelfAttention3D, an f32 DiT's cross-attention. It
//   computes softmax(q k^T * sm_scale) v in f32 throughout: f32 logits, an
//   online softmax with an f32 running max and sum, f32 PV. [B, N, h, d]
//   strided views, Nq != Nk allowed, keys >= Nk masked, d = 64, 96 or 128.
//   It runs on the CUDA cores (FFMA): TF32 tensor cores would keep about
//   three decimal digits, and the port runs with TF32 off.
//
// What bounds it: 4*Nq*Nk*d f32 operations a (batch, head) at the card's
// 67 TFLOP/s CUDA-core rate, against (2 Nq + 2 Nk)*d*4 bytes: operations.
//
// Design (a first, simple version): one block of 256 threads per
// (batch*head, 64 query rows), looping over tiles of 64 keys. Q, K and V
// tiles are staged in shared memory by the threads (16-byte loads, rows past
// Nq or Nk as zeros); thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// 4ty .. 4ty+3 and keys (then output columns) tx + 16j, so a row's 16
// threads sit in one half-warp and reduce its max and sum with shuffles. K
// rows are padded to d + 1 floats, so the 16 keys a half-warp reads at one
// column lie in 16 banks. S and P live in registers and one shared P tile
// (base-2 exponent, log2 e folded into the scale); the output rows (4 x
// d/16 a thread) are rescaled by each tile's change of the running max and
// divided by the sum at the end. No tensor cores, no TMA, no pipelining.
//
// Tensors are addressed by element strides (batch, token, head). The entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows a block
constexpr int kKeys = 64;     // keys a tile
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, n, h;  // elements between batches, tokens, heads
};

template <int D>
struct F32Smem {
  static constexpr int kLdq = D + 1;  // Q and K row pitch (floats)
  static constexpr int kLdp = kKeys + 1;
  static constexpr int kBytes =
      (kRows * kLdq + kKeys * kLdq + kKeys * D + kRows * kLdp) * 4;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// `rows` rows of d floats (row pitch `sn` elements in global memory, `ld` in
// shared memory) into shared memory, rows at or past `valid` as zeros.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, long long sn,
                                           int rows, int valid) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = *reinterpret_cast<const float4*>(src + r * sn + c);
    float* p = dst + r * ld + c;
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int nq, int nk, Strides sq, Strides sk,
                     Strides sv, Strides so, float scale_log2) {
  using S = F32Smem<D>;
  constexpr int kCols = D / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kRows * S::kLdq;
  float* sV = sK + kKeys * S::kLdq;
  float* sP = sV + kKeys * D;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  stage_rows<D>(sQ, S::kLdq, q + b * sq.b + h * sq.h + q0 * sq.n, sq.n,
                kRows, nq - q0);
  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += kKeys) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage_rows<D>(sK, S::kLdq, kb + k0 * sk.n, sk.n, kKeys, nk - k0);
    stage_rows<D>(sV, D, vb + k0 * sv.n, sv.n, kKeys, nk - k0);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(4 * ty + i) * S::kLdq + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * S::kLdq + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
    const int kvalid = nk - k0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = tx + 16 * j < kvalid ? s[i][j] * scale_log2 : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one real key, so mx is finite here
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        sum += p;
        sP[(4 * ty + i) * S::kLdp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * S::kLdp + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= nq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[r * so.n + tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, int B, int H, int nq, int nk, Strides sq,
                       Strides sk, Strides sv, Strides so, float scale_log2,
                       cudaStream_t st) {
  constexpr int smem = F32Smem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if ((long long)B * H > 65535) return cudaErrorInvalidValue;
  const dim3 grid((nq + kRows - 1) / kRows, B * H);
  flash_f32_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, v, o, H, nq, nk, sq, sk, sv, so, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: f32 [B, nq, H, d]; k, v: f32 [B, nk, H, d], by element strides
// (batch, token, head), 16-byte aligned.
int flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int nq, int nk, int d, long long q_sb,
                   long long q_sn, long long q_sh, long long k_sb,
                   long long k_sn, long long k_sh, long long v_sb,
                   long long v_sn, long long v_sh, long long o_sb,
                   long long o_sn, long long o_sh, float sm_scale,
                   void* stream) {
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(o);
  cudaError_t e;
  if (d == 128)
    e = launch_f32<128>(qp, kp, vp, op, B, H, nq, nk, sq, sk, sv, so,
                        scale_log2, st);
  else if (d == 96)
    e = launch_f32<96>(qp, kp, vp, op, B, H, nq, nk, sq, sk, sv, so,
                       scale_log2, st);
  else if (d == 64)
    e = launch_f32<64>(qp, kp, vp, op, B, H, nq, nk, sq, sk, sv, so,
                       scale_log2, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
