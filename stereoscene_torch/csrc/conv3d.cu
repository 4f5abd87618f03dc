// 3x3x3 stride-1 pad-1 conv3d as an implicit GEMM (K4).
//
// Replaces stereoscene_tpu/ops/pallas_conv3d.py (_conv3d_s1_single / _kernel,
// public conv3d_s1_pallas): there the TPU kernel DMA'd a three-slice halo
// block into VMEM, built an im2col scratch per depth tap at 128-lane
// offsets and ran one [BH*W, 9*CL] x [9*CL, Co] MXU dot per tap. Hopper has
// no VMEM to hold a halo block of that size, so the im2col matrix is never
// built at all: each block gathers the rows of the current tap straight
// from the channels-last input into shared memory.
//
// The GEMM, per sample: M = D*H*W output voxels, N = Co, K = 27*Ci.
//   y[m, n] = sum_{tap, ci} x[m shifted by tap, ci] * w[tap, ci, n]
// with zero where the shifted voxel falls outside the volume.
//
// What bounds it on an H100: operations. At the flagship's 64 -> 64 conv
// at [56, 24, 80] the GEMM is 2 * 107,520 * 64 * 1,728 = 23.8 GFLOP against
// 27.8 MB of bf16 input, output and weights: 856 FLOP per byte, far above
// the card's ~295 FLOP/B ridge. This first design runs on the CUDA cores in
// fp32 (no tensor cores yet): a classic 64 x 64 register-tiled SGEMM loop
// whose A tile is a masked gather. Its ceiling is the 67 TFLOP/s fp32 rate,
// not the 989 TFLOP/s bf16 tensor-core rate the bound assumes; wgmma and
// TMA are later work.
//
// Design: one 256-thread block per (64 output voxels, 64 output channels,
// sample). For each of the 27 taps and each 16-channel slice of Ci, the
// block stages A = the 64 shifted input rows x 16 channels (zero outside
// the volume) and B = the 16 x 64 weight slice in shared memory as fp32,
// then every thread accumulates a 4 x 4 patch of outputs in registers.
// Each voxel's (d, h, w) is decoded once per block. The output is written
// once, in the input's dtype.
//
// Layouts: x [B, D, H, W, Ci] and y [B, D, H, W, Co] (a channels_last_3d
// NCDHW tensor is exactly this in memory); w [27, Ci, Co], taps in
// (kd, kh, kw) order. Ci must be a multiple of 16; any Co.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;   // output voxels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per shared-memory stage
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv3d_s1_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int D, int H, int W, int Ci, int Co) {
  __shared__ float As[kBK][kBM + 1];  // +1: the transposed store is
                                       // free of bank conflicts
  __shared__ float Bs[kBK][kBN];
  __shared__ int sd[kBM], sh[kBM], sw[kBM];

  const long M = (long)D * H * W;
  const long m0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long b = blockIdx.z;
  const T* xb = x + b * M * Ci;
  const int t = threadIdx.x;

  if (t < kBM) {
    const long m = m0 + t;
    if (m < M) {
      sw[t] = (int)(m % W);
      sh[t] = (int)((m / W) % H);
      sd[t] = (int)(m / ((long)W * H));
    } else {
      sd[t] = -1000;  // every tap of a row past the end reads zeros
      sh[t] = 0;
      sw[t] = 0;
    }
  }
  __syncthreads();

  const int tx = t % 16;  // output channels tx + 16 j
  const int ty = t / 16;  // output voxels ty + 16 i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
    for (int c0 = 0; c0 < Ci; c0 += kBK) {
      // A: 64 rows x 16 channels, 4 per thread; 16 neighbouring threads
      // read one row's 16 contiguous channels
#pragma unroll
      for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
        const int idx = t + r * kThreads;
        const int row = idx / kBK, col = idx % kBK;
        const int d = sd[row] + kd, h = sh[row] + kh, ww = sw[row] + kw;
        float v = 0.f;
        if (d >= 0 && d < D && h >= 0 && h < H && ww >= 0 && ww < W)
          v = to_float(xb[(((long)d * H + h) * W + ww) * Ci + c0 + col]);
        As[col][row] = v;
      }
      // B: 16 channels x 64 outputs, 4 per thread, coalesced along Co
      const T* wt = w + ((long)tap * Ci + c0) * Co;
#pragma unroll
      for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
        const int idx = t + r * kThreads;
        const int k = idx / kBN, n = idx % kBN;
        Bs[k][n] = (n0 + n < Co) ? to_float(wt[(long)k * Co + n0 + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  T* yb = y + b * M * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Co) store(yb + m * Co + n, acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int stereoscene_conv3d_s1(const void* x, const void* w, void* y,
                                     int B, int D, int H, int W, int Ci,
                                     int Co, int bf16, void* stream) {
  const long M = (long)D * H * W;
  dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((Co + kBN - 1) / kBN),
            (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    conv3d_s1_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), D, H, W, Ci, Co);
  } else {
    conv3d_s1_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), D, H, W, Ci, Co);
  }
  return (int)cudaGetLastError();
}
