// Weight gradient of the sparse submanifold 3x3x3 convolution on voxel rows
// for Hopper (sm_90a), f32, behind a plain C interface (loaded with ctypes by
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
// What bounds it: f32 FFMA on the CUDA cores (67 TFLOP/s on an H100 SXM), as
// the forward: 2 * F * Fo operations per present (row, tap) pair against
// (F + Fo) * 4 bytes per row, far above the ridge, so operations bound it.
//
// Design: per tap the product is [F x rows] . [rows x Fo], long in the rows
// and with only 27 * ceil(F/64) * ceil(Fo/64) output tiles (27 at 64 -> 64),
// too few for 132 SMs. So the B * C rows are cut into S ranges and a block
// owns (range, tap, 64 x 64 output tile): it walks its range in chunks of 16
// rows, skips a chunk none of whose rows has the tap's neighbour, gathers the
// 16 neighbour rows of feats (zeros for -1) and the 16 rows of g into shared
// memory, and each of its 256 threads accumulates a 4 x 4 sub-tile in f32
// registers. It writes its tile of partial[s]; a second kernel sums the S
// partials in the order s = 0 .. S-1. No atomics: the TPU kernel accumulates
// over its sequential grid in a fixed order, and so does this pair, so the
// result is bit-identical from run to run. The next chunk's neighbour index
// is fetched before the current chunk's products; no double buffering of the
// tiles yet.
//
// The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBF = 64;   // input features (rows of dw[t]) per block
constexpr int kBN = 64;   // output features per block
constexpr int kBK = 16;   // voxel rows per chunk
constexpr int kThreads = 256;
constexpr int kTaps = 27;

__global__ void __launch_bounds__(kThreads)
    sparse_wgrad_kernel(const float* __restrict__ feats,
                        const int* __restrict__ nbr,
                        const float* __restrict__ g,
                        float* __restrict__ partial, long long rows, int C,
                        int F, int Fo, int rows_per_split, int tiles_f,
                        int tiles_o) {
  __shared__ __align__(16) float sA[kBK][kBF];  // gathered feats rows
  __shared__ __align__(16) float sB[kBK][kBN];  // rows of g

  const int tid = threadIdx.x;
  int tile = blockIdx.x;
  const int to = tile % tiles_o;
  tile /= tiles_o;
  const int tf = tile % tiles_f;
  const int t = tile / tiles_f;
  const int s = blockIdx.y;
  const int f0 = tf * kBF, n0 = to * kBN;
  const int tx = tid % 16, ty = tid / 16;

  const long long r_begin = (long long)s * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > rows) r_end = rows;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // loader: thread -> (row of the chunk, 4 features of the tile)
  const int lk = tid / 16, lc = (tid % 16) * 4;
  long long row = r_begin + lk;
  int src = row < r_end ? nbr[row * kTaps + t] : -1;
  for (long long r0 = r_begin; r0 < r_end; r0 += kBK) {
    const int cur = src;
    const long long cur_row = row;
    row += kBK;
    src = row < r_end ? nbr[row * kTaps + t] : -1;
    // also the barrier between the previous chunk's reads and these writes
    if (!__syncthreads_or(cur >= 0)) continue;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cur >= 0) {
      const long long batch_row0 = (cur_row / C) * C;
      if (f0 + lc < F)
        a = *reinterpret_cast<const float4*>(feats + (batch_row0 + cur) * F +
                                             f0 + lc);
      if (n0 + lc < Fo)
        b = *reinterpret_cast<const float4*>(g + cur_row * Fo + n0 + lc);
    }
    *reinterpret_cast<float4*>(&sA[lk][lc]) = a;
    *reinterpret_cast<float4*>(&sB[lk][lc]) = b;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sB[k][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
  }

  const int n = n0 + tx * 4;
  if (n >= Fo) return;
  float* out = partial + ((long long)s * kTaps + t) * F * Fo;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty * 4 + i;
    if (f < F)
      *reinterpret_cast<float4*>(out + (long long)f * Fo + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// dw[i] = partial[0][i] + partial[1][i] + ... in that order, 4 values a thread
__global__ void __launch_bounds__(kThreads)
    sparse_wgrad_reduce_kernel(const float* __restrict__ partial,
                               float* __restrict__ dw, long long n4, int S) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
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

}  // namespace

extern "C" {

// feats [B, C, F], nbr int32 [B, C, 27], g [B, C, Fo] -> dw [27, F, Fo];
// partial is scratch of [S, 27, F, Fo] floats with S = ceil(B * C /
// rows_per_split); rows_per_split is a multiple of 16.
int sparse_conv_f32_wgrad(const void* feats, const void* nbr, const void* g,
                          void* partial, void* dw, int B, int C, int F, int Fo,
                          int rows_per_split, void* stream) {
  if (B <= 0 || C <= 0 || F <= 0 || Fo <= 0 || F % 4 || Fo % 4 ||
      rows_per_split <= 0 || rows_per_split % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * C;
  const long long S = (rows + rows_per_split - 1) / rows_per_split;
  const int tiles_f = (F + kBF - 1) / kBF, tiles_o = (Fo + kBN - 1) / kBN;
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kTaps * tiles_f * tiles_o, static_cast<unsigned>(S));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sparse_wgrad_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(feats), static_cast<const int*>(nbr),
      static_cast<const float*>(g), static_cast<float*>(partial), rows, C, F,
      Fo, rows_per_split, tiles_f, tiles_o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = (long long)kTaps * F * Fo / 4;
  sparse_wgrad_reduce_kernel<<<static_cast<unsigned>((n4 + kThreads - 1) /
                                                     kThreads),
                               kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n4,
      static_cast<int>(S));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
