// Row gather along axis 0 (P2).
//
// Replaces the Pallas probe kernels of tools/probe_gather.py (run, with
// k_taa_full, k_taa_1col and k_take): take_along_axis(feat, idx, axis=0)
// with the index given per element [M, C], per row [M, 1], or flat [M]:
//
//   out[i, c] = feat[idx[i * idx_row_stride + c * idx_col_stride], c]
//
// with idx_col_stride 1 (per element, row stride C) or 0 (one index per row,
// row stride 1). On the TPU, Mosaic could only gather within one vreg, which
// is what the probe tested; on Hopper a gather is a plain load.
//
// What bounds it on an H100: at the probe's shapes (feat [7680, 128] fp32,
// M = 1024) the function moves about 1-1.6 MB, well under a microsecond at
// 3.35 TB/s, so the launch itself is the floor.
//
// Design: one thread per output element, consecutive threads on consecutive
// channels, so the per-row layouts read and write whole 128-byte lines and
// the per-element layout writes them. Indices are clamped to [0, R) so a bad
// index cannot read outside feat.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) take_rows_kernel(
    const float* __restrict__ feat, const int* __restrict__ idx,
    float* __restrict__ out, int M, int C, int R, int idx_col_stride) {
  const size_t total = (size_t)M * C;
  const int idx_row_stride = idx_col_stride ? C : 1;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int i = (int)(e / C);
    const int c = (int)(e - (size_t)i * C);
    int r = __ldg(idx + (size_t)i * idx_row_stride + c * idx_col_stride);
    r = min(max(r, 0), R - 1);
    out[e] = __ldg(feat + (size_t)r * C + c);
  }
}

}  // namespace

extern "C" int stereoscene_take_rows(const void* feat, const void* idx,
                                     void* out, int M, int C, int R,
                                     int idx_col_stride, void* stream) {
  if (M < 1 || C < 1 || R < 1 || (idx_col_stride != 0 && idx_col_stride != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t total = (size_t)M * C;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 65535
                               ? (total + kThreads - 1) / kThreads
                               : 65535);
  take_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int*>(idx),
      static_cast<float*>(out), M, C, R, idx_col_stride);
  return static_cast<int>(cudaGetLastError());
}
