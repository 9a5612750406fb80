// Sparse submanifold 3x3x3 convolution on voxel rows for Hopper (sm_90a),
// f32, behind a plain C interface (loaded with ctypes by
// infinicube_tpu_torch/kernels).
//
// sparse_conv_f32 (K4) replaces the forward of the TPU kernel
//   infinicube_tpu/ops/window_conv.py:222 `_conv_core` (reached through
//   `window_sparse_conv`), which runs every SparseConv3d of the sparse VAE's
//   structure decoder: 12 per decode at (F, Fo) in {(256, 256), (256, 128),
//   (128, 128), (128, 64), (64, 64)} on 32,768 .. 131,072 voxel rows.
//   out[b, m] = sum_t feats[b, nbr[b, m, t]] @ w[t]   (absent taps: -1, zero)
//   and every row of a batch element with poison[b] != 0 is NaN (the loud
//   dense-bounds policy of window_conv.py:313).
//
// What bounds it: the release VAE computes in f32, so this first version
// does f32 FFMA on the CUDA cores (67 TFLOP/s on an H100 SXM, no tensor
// cores); 2 * 27 * F * Fo operations per present (row, tap) pair against
// about (F + Fo) * 4 bytes per row, far above the ridge, so operations bound
// it.
//
// Design: the TPU kernel's window plan (9 directional windows, one-hot
// selection matmuls, a miss list with an exact fallback) worked around the
// TPU's slow gathers. Here a block loads its own neighbour indices and
// gathers rows directly, so nothing is missed and no fallback exists. A block
// of 256 threads owns a 64-row x 64-feature output tile; it keeps the tile's
// 27 x 64 neighbour indices in shared memory, skips a tap when none of its
// rows has that neighbour, and for each 16-feature chunk gathers the 64
// neighbour rows (zeros for -1) and the weight rows into shared memory; each
// thread accumulates a 4 x 4 sub-tile in f32 registers. No double buffering
// yet.
//
// The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // voxel rows per block
constexpr int kBN = 64;   // output features per block
constexpr int kBK = 16;   // input features per chunk
constexpr int kThreads = 256;
constexpr int kTaps = 27;

__global__ void __launch_bounds__(kThreads)
    sparse_conv_kernel(const float* __restrict__ feats,
                       const int* __restrict__ nbr, const float* __restrict__ w,
                       const int* __restrict__ poison,
                       float* __restrict__ out, int C, int F, int Fo) {
  __shared__ int sN[kTaps][kBM];
  __shared__ __align__(16) float sA[kBK][kBM + 4];  // gathered rows, k-major
  __shared__ __align__(16) float sB[kBK][kBN];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)b * C;

  if (poison[b]) {
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int m = m0 + i / kBN, n = n0 + i % kBN;
      if (m < C && n < Fo) out[(row0 + m) * Fo + n] = nanf("");
    }
    return;
  }
  for (int i = tid; i < kTaps * kBM; i += kThreads) {
    const int r = i / kTaps, t = i % kTaps;
    sN[t][r] = m0 + r < C ? nbr[(row0 + m0 + r) * kTaps + t] : -1;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int ar = tid / 4, ak = (tid % 4) * 4;    // A loader: row, features
  const int bk = tid / 16, bn = (tid % 16) * 4;  // B loader: k row, columns
  for (int t = 0; t < kTaps; ++t) {
    const int present = tid < kBM ? sN[t][tid] >= 0 : 0;
    if (!__syncthreads_or(present)) continue;
    const int src = sN[t][ar];
    for (int k0 = 0; k0 < F; k0 += kBK) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0 && k0 + ak < F)
        a = *reinterpret_cast<const float4*>(feats + (row0 + src) * F + k0 +
                                             ak);
      sA[ak + 0][ar] = a.x;
      sA[ak + 1][ar] = a.y;
      sA[ak + 2][ar] = a.z;
      sA[ak + 3][ar] = a.w;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + bk < F && n0 + bn < Fo)
        bv = *reinterpret_cast<const float4*>(
            w + ((long long)t * F + k0 + bk) * Fo + n0 + bn);
      *reinterpret_cast<float4*>(&sB[bk][bn]) = bv;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
        const float4 wv = *reinterpret_cast<const float4*>(&sB[k][tx * 4]);
        const float ai[4] = {av.x, av.y, av.z, av.w};
        const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], wj[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int n = n0 + tx * 4;
  if (n >= Fo) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < C)
      *reinterpret_cast<float4*>(out + (row0 + m) * Fo + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

extern "C" {

int sparse_conv_f32(const void* feats, const void* nbr, const void* w,
                    const void* poison, void* out, int B, int C, int F, int Fo,
                    void* stream) {
  if (B <= 0 || C <= 0 || F % 4 || Fo % 4 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kBM - 1) / kBM, (Fo + kBN - 1) / kBN, B);
  sparse_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(nbr),
      static_cast<const float*>(w), static_cast<const int*>(poison),
      static_cast<float*>(out), C, F, Fo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
