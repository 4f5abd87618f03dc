// Deformable-convolution gather over precomputed tap products (P1).
//
// Replaces the Pallas probe kernel tools/probe_pallas_dcn.py (pallas_dcn /
// _dcn_kernel): DCNv1 as a z-gather. The wrapper (ops/deform_conv.py)
// computes z_t = grouped_matmul(x, W_t) for the K = kw * kw taps with
// torch.bmm; this kernel takes z and the learned offsets and computes
//
//   out[n, :] = sum_{t < K, c < 4} wgt[n, t, c] * z[t, idx[n, t, c], :]
//
// with fp32 accumulation and one write in z's dtype, where idx / wgt are the
// four bilinear corners of tap t's sample of pixel n: the flat row of each
// corner clipped into the map (batch offset included) and its weight, zero
// where the corner lies off the map. The probe's corner_tables built these
// tables outside its kernel; here each block derives its rows' corners from
// the offsets with the same fp32 operations as ops/deform_conv.py:
// dcn_corner_tables, which the plain version uses. The gather commutes with
// the channel contraction, so this equals the bilinear-sample-then-matmul
// DCN exactly in real arithmetic.
//
// What bounds it on an H100: bytes. At the flagship DepthNet DCN (B = 1,
// 48 x 160, C = 640, K = 9) z is 88.5 MB in bf16, the offsets 0.55 MB and
// the output 9.8 MB: ~30 us at 3.35 TB/s if every z row were read once.
// Each output row gathers 36 z rows, but a sample's corners lie within a few
// pixels of it, so neighbouring rows of a block and of the blocks resident at
// the same time reuse the same z rows from L1 / L2.
//
// Design: one warp per output row, eight rows per 256-thread block. The
// block's first 8 * K threads each compute one (row, tap) sample's four
// corners and weights into shared memory; each lane then owns 16-byte
// vectors of channels (8 bf16 or 4 fp32), walks the 36 (tap, corner)
// samples with independent 16-byte loads and fused multiply-adds in fp32,
// and writes its vector once. No atomics: the TPU kernel's grid carried the
// sum across taps in the output block, here the tap loop runs inside the
// thread. Every corner index is clipped into the map, so no offset can read
// outside z.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per output row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kCorners = 4;
constexpr int kMaxTaps = 9;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;  // fp32 per 16-byte vector
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// bf16 is the high half of an fp32: widening is a shift, narrowing rounds
// to nearest even (__float2bfloat16), as PyTorch's cast does.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;  // bf16 per 16-byte vector
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) dcn_gather_kernel(
    const T* __restrict__ z, const float* __restrict__ offsets,
    T* __restrict__ out, int N, int C, int H, int W, int kw) {
  __shared__ int s_idx[kRowsPerBlock * kMaxTaps * kCorners];
  __shared__ float s_wgt[kRowsPerBlock * kMaxTaps * kCorners];
  const int K = kw * kw;
  const int samples = K * kCorners;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, N - row0);
  if (threadIdx.x < rows * K) {
    // one (row, tap) sample: its position, floor and four corners, in the
    // order and with the fp32 operations of dcn_corner_tables
    const int r = threadIdx.x / K;
    const int t = threadIdx.x - r * K;
    const int n = row0 + r;
    const int hw = H * W;
    const int b = n / hw;
    const int y = (n - b * hw) / W;
    const int x = n - b * hw - y * W;
    const float half = 0.5f * (float)(kw - 1);
    const float ky = (float)(t / kw) - half;
    const float kx = (float)(t % kw) - half;
    const float2 o = __ldg(reinterpret_cast<const float2*>(offsets) +
                           (size_t)n * K + t);
    const float sy = ((float)y + ky) + o.x;
    const float sx = ((float)x + kx) + o.y;
    const float y0 = floorf(sy), x0 = floorf(sx);
    const float fy = sy - y0, fx = sx - x0;
    const int y0i = (int)y0, x0i = (int)x0;
    const float wy[2] = {1.f - fy, fy};
    const float wx[2] = {1.f - fx, fx};
#pragma unroll
    for (int c = 0; c < kCorners; ++c) {
      const int yi = y0i + (c >> 1), xi = x0i + (c & 1);
      const bool inside = yi >= 0 && yi < H && xi >= 0 && xi < W;
      const int j = r * samples + t * kCorners + c;
      s_idx[j] = min(max(yi, 0), H - 1) * W + min(max(xi, 0), W - 1) + b * hw;
      s_wgt[j] = inside ? wy[c >> 1] * wx[c & 1] : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int* row_idx = s_idx + warp * samples;
  const float* row_wgt = s_wgt + warp * samples;
  constexpr int V = Vec<T>::n;
  const size_t tap_stride = (size_t)N * C;
  T* orow = out + (size_t)(row0 + warp) * C;
  for (int c0 = lane * V; c0 < C; c0 += 32 * V) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int t = 0; t < K; ++t) {
      const T* zt = z + t * tap_stride + c0;
#pragma unroll
      for (int c = 0; c < kCorners; ++c) {
        float val[V];
        Vec<T>::load(zt + (size_t)row_idx[t * kCorners + c] * C, val);
        const float w = row_wgt[t * kCorners + c];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(w, val[j], acc[j]);
      }
    }
    Vec<T>::store(orow + c0, acc);
  }
}

template <typename T>
cudaError_t launch(const void* z, const void* offsets, void* out, int N,
                   int C, int H, int W, int kw, cudaStream_t stream) {
  if (kw < 1 || kw * kw > kMaxTaps || C % Vec<T>::n != 0 || N < 1 ||
      H < 1 || W < 1 || N % (H * W) != 0) {
    return cudaErrorInvalidValue;
  }
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  dcn_gather_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const float*>(offsets),
      static_cast<T*>(out), N, C, H, W, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stereoscene_dcn_gather(const void* z, const void* offsets,
                                      void* out, int N, int C, int H, int W,
                                      int kw, int z_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      z_bf16 ? launch<__nv_bfloat16>(z, offsets, out, N, C, H, W, kw, s)
             : launch<float>(z, offsets, out, N, C, H, W, kw, s);
  return static_cast<int>(err);
}
