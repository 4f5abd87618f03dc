// Row gather along axis 0 (P2).
//
// Replaces the Pallas probe kernels of tools/probe_gather.py (run, with
// k_taa_full, k_taa_1col and k_take): take_along_axis(feat, idx, axis=0)
// with the index given per element [M, C], per row [M, 1], or flat [M]:
//
//   out[i, c] = feat[clamp(idx[i, c or 0], 0, R - 1), c]
//
// idx_col_stride 1 means one index per element, 0 one index per row. On the
// TPU, Mosaic could only gather within one vreg, which is what the probe
// tested; on Hopper a gather is a plain load.
//
// What bounds it on an H100: at the probe's shapes (feat [7680, 128] fp32,
// M = 1024) the function moves about 1-1.6 MB, well under a microsecond at
// 3.35 TB/s, so the launch itself is the floor, and the wrapper's host time
// (ops/gather.py, _build.launch) is most of a call.
//
// Design: one warp per output row, eight rows a block, no division per
// element. A per-row or flat index is loaded once for the row; the row
// then moves as 16-byte vectors when C % 4 == 0 and feat and out are
// 16-byte aligned, else one float a lane. A per-element index row moves the
// same way: a lane loads 4 consecutive indices as one vector and gathers its
// 4 channels, or one index and one channel where the vectors do not align.
// Indices are clamped to [0, R) so a bad index cannot read outside feat.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per output row

__device__ __forceinline__ int clamp_row(int r, int R) {
  return min(max(r, 0), R - 1);
}

template <bool kPerElement, bool kVec>
__global__ void __launch_bounds__(kThreads) take_rows_kernel(
    const float* __restrict__ feat, const int* __restrict__ idx,
    float* __restrict__ out, int M, int C, int R) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  float* orow = out + (size_t)row * C;
  if (kPerElement) {
    const int* irow = idx + (size_t)row * C;
    if (kVec) {
      for (int v = lane; v < C / 4; v += 32) {
        const int4 r = __ldg(reinterpret_cast<const int4*>(irow) + v);
        const int c = 4 * v;
        reinterpret_cast<float4*>(orow)[v] = make_float4(
            __ldg(feat + (size_t)clamp_row(r.x, R) * C + c),
            __ldg(feat + (size_t)clamp_row(r.y, R) * C + c + 1),
            __ldg(feat + (size_t)clamp_row(r.z, R) * C + c + 2),
            __ldg(feat + (size_t)clamp_row(r.w, R) * C + c + 3));
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        orow[c] = __ldg(feat + (size_t)clamp_row(__ldg(irow + c), R) * C + c);
      }
    }
  } else {
    const float* frow = feat + (size_t)clamp_row(__ldg(idx + row), R) * C;
    if (kVec) {
      for (int v = lane; v < C / 4; v += 32) {
        reinterpret_cast<float4*>(orow)[v] =
            __ldg(reinterpret_cast<const float4*>(frow) + v);
      }
    } else {
      for (int c = lane; c < C; c += 32) orow[c] = __ldg(frow + c);
    }
  }
}

template <bool kPerElement, bool kVec>
cudaError_t launch(const void* feat, const void* idx, void* out, int M, int C,
                   int R, cudaStream_t stream) {
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  take_rows_kernel<kPerElement, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(feat), static_cast<const int*>(idx),
      static_cast<float*>(out), M, C, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stereoscene_take_rows(const void* feat, const void* idx,
                                     void* out, int M, int C, int R,
                                     int idx_col_stride, void* stream) {
  if (M < 1 || C < 1 || R < 1 || (idx_col_stride != 0 && idx_col_stride != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool per_element = idx_col_stride == 1;
  // the pointers a lane reads or writes 16 bytes at a time
  const uintptr_t vec_ptrs =
      (uintptr_t)out | (per_element ? (uintptr_t)idx : (uintptr_t)feat);
  const bool vec = C % 4 == 0 && vec_ptrs % 16 == 0;
  cudaError_t err;
  if (per_element) {
    err = vec ? launch<true, true>(feat, idx, out, M, C, R, s)
              : launch<true, false>(feat, idx, out, M, C, R, s);
  } else {
    err = vec ? launch<false, true>(feat, idx, out, M, C, R, s)
              : launch<false, false>(feat, idx, out, M, C, R, s);
  }
  return static_cast<int>(err);
}
