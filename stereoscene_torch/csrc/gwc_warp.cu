// Fused group-wise correlation + disparity->depth warp (K1).
//
// Replaces the Pallas kernel stereoscene_tpu/ops/pallas_gwc.py
// (_fused_one / _kernel, public fused_gwc_warp). For every output
// (b, k, h, w, g):
//
//   out = (w0[k] * sum_c L[h, w, g*cpg+c] * R[h, w - i0[k],     g*cpg+c]
//        + w1[k] * sum_c L[h, w, g*cpg+c] * R[h, w - i0[k] - 1, g*cpg+c]) / cpg
//
// where a right column outside [0, W) reads as zero (the correlation's
// validity mask) and i0 / w0 / w1 are the grid_sample(align_corners,
// zeros) lerp coefficients of the depth warp at positions[b, k]. The
// kernel derives them itself, in fp32 and in the order of ops/gwc.py
// warp_coeffs (pallas_gwc.py _warp_coeffs): i0 = floor(pos) clipped to
// [-1, D-1], w1 = pos - floor(pos), w0 = 1 - w1, each weight zeroed where
// its corner lies outside [0, D-1].
//
// What bounds it on an H100: the output write. At the flagship shapes
// (left/right [1, 48, 160, 64], K = D = 112, G = 32) the kernel reads 2 MB
// of bf16 features and writes the [1, 112, 48, 160, 32] volume once: 55 MB
// in bf16, 16.4 us at 3.35 TB/s. The math is ~10 flops per output value.
//
// Design, for the write:
// - One block per (b, h, tile of kTileW = 32 output columns, chunk of 56
//   depths): 480 blocks of 256 threads at the flagship. The block
//   stages only what its columns read, in the input dtype, with 16-byte
//   loads: left [32, C] and the right window [w0 - D, w0 + 32], the
//   32 + D + 1 columns that i0 in [-1, D-1] can reach (zeros outside the
//   row). Each staged row is 16 bytes longer than C so that neighbouring
//   columns' 16-byte reads fall in different banks. That is 25 KB in bf16
//   at the flagship, so eight blocks fit on an SM.
// - The block's 56 (i0, w0, w1) are computed from positions into shared
//   memory once; the wrapper launches nothing else. With 56 depths per
//   block each row is staged twice at the flagship (K = 112), not seven
//   times as with 16.
// - Each thread produces 8 adjacent groups of one (k, w): it holds its 16
//   left channels in registers across the block's depths, reads two
//   16-channel right vectors per depth, sums in fp32 and writes the 8
//   values as one 16-byte store (bf16) or two (fp32). A warp writes 512
//   contiguous bytes of the output.
// - Shapes off that path (G not a multiple of 8, cpg != 2, unaligned
//   tensors) take a generic loop over the same staged rows: one thread per
//   (k, w, g), scalar reads and writes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;          // output columns per block
constexpr int kDepthPerBlock = 56;  // depths per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// n values of T at a 16-byte aligned shared address -> fp32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < N / kPer; ++v) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[v];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[v * kPer + i] = to_f32(e[i]);
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// kFast: G % 8 == 0, cpg == 2, kThreads % (kTileW * G / 8) == 0, every
// pointer 16-byte aligned (the launcher checks)
template <typename Tin, typename Tout, bool kFast>
__global__ void __launch_bounds__(kThreads) gwc_warp_kernel(
    const Tin* __restrict__ left, const Tin* __restrict__ right,
    const float* __restrict__ positions, Tout* __restrict__ out, int H,
    int W, int C, int G, int K, int D) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int s_i0[kDepthPerBlock];
  __shared__ float s_w0[kDepthPerBlock], s_w1[kDepthPerBlock];
  constexpr int kVec = 16 / sizeof(Tin);  // elements per 16 bytes
  const int ld = C + kVec;                // staged row, padded by 16 bytes
  Tin* lrow = reinterpret_cast<Tin*>(smem_raw);  // [kTileW, ld]
  Tin* rwin = lrow + kTileW * ld;                // [kTileW + D + 1, ld]

  const int wtiles = (W + kTileW - 1) / kTileW;
  const int w0 = (blockIdx.x % wtiles) * kTileW;
  const int k0 = (blockIdx.x / wtiles) * kDepthPerBlock;
  const int nk = min(K - k0, kDepthPerBlock);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid < nk) {  // ops/gwc.py warp_coeffs, in fp32
    const float pos = positions[(long)b * K + k0 + tid];
    const int lo = (int)floorf(pos);
    const float w1 = pos - (float)lo;
    const float w0v = 1.f - w1;
    s_w0[tid] = (lo >= 0 && lo <= D - 1) ? w0v : 0.f;
    s_w1[tid] = (lo + 1 >= 0 && lo + 1 <= D - 1) ? w1 : 0.f;
    s_i0[tid] = min(max(lo, -1), D - 1);
  }

  const long row = ((long)b * H + h) * (long)W * C;
  const int rcols = kTileW + D + 1;
  const int rbase = w0 - D;  // global column of window column 0
  if (kFast) {
    const int vpr = C / kVec;  // 16-byte vectors per row
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < kTileW * vpr; i += kThreads) {
      const int col = i / vpr, v = i - col * vpr;
      const uint4 val =
          w0 + col < W ? reinterpret_cast<const uint4*>(
                             left + row + (long)(w0 + col) * C)[v]
                       : zero;
      reinterpret_cast<uint4*>(lrow + col * ld)[v] = val;
    }
    for (int i = tid; i < rcols * vpr; i += kThreads) {
      const int col = i / vpr, v = i - col * vpr;
      const int gc = rbase + col;
      const uint4 val =
          (gc >= 0 && gc < W)
              ? reinterpret_cast<const uint4*>(right + row + (long)gc * C)[v]
              : zero;
      reinterpret_cast<uint4*>(rwin + col * ld)[v] = val;
    }
  } else {
    for (int i = tid; i < kTileW * C; i += kThreads) {
      const int col = i / C, c = i - col * C;
      lrow[col * ld + c] =
          w0 + col < W ? left[row + (long)(w0 + col) * C + c] : Tin(0.f);
    }
    for (int i = tid; i < rcols * C; i += kThreads) {
      const int col = i / C, c = i - col * C;
      const int gc = rbase + col;
      rwin[col * ld + c] =
          (gc >= 0 && gc < W) ? right[row + (long)gc * C + c] : Tin(0.f);
    }
  }
  __syncthreads();

  const int cpg = C / G;
  const float inv_cpg = 1.f / (float)cpg;
  // out[b, k, h, w, :] starts at ((b * K + k) * H + h) * W * G + w * G
  const long slab = (long)H * W * G;
  Tout* out_bh = out + ((long)b * K + k0) * slab + (long)h * W * G;

  if (kFast) {
    const int octs = G / 8;
    const int items = kTileW * octs;  // divides kThreads
    const int item = tid % items;
    const int x = item / octs, oct = item - x * octs;
    if (w0 + x < W) {
      float l[16];
      load_vec<Tin, 16>(lrow + x * ld + oct * 16, l);
      for (int kk = tid / items; kk < nk; kk += kThreads / items) {
        // window column of right column w - i0 is x + D - i0; disparity
        // i0 + 1 sits one column to the left
        const Tin* r0 = rwin + (x + D - s_i0[kk]) * ld + oct * 16;
        float a[16], c[16];
        load_vec<Tin, 16>(r0, a);
        load_vec<Tin, 16>(r0 - ld, c);
        const float c0 = s_w0[kk] * inv_cpg, c1 = s_w1[kk] * inv_cpg;
        float o[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int e = 2 * g;
          const float a0 = fmaf(l[e + 1], a[e + 1], l[e] * a[e]);
          const float a1 = fmaf(l[e + 1], c[e + 1], l[e] * c[e]);
          o[g] = a0 * c0 + a1 * c1;
        }
        store8(out_bh + kk * slab + (long)(w0 + x) * G + oct * 8, o);
      }
    }
  } else {
    const int items = kTileW * G;
    for (int idx = tid; idx < nk * items; idx += kThreads) {
      const int kk = idx / items, rem = idx - kk * items;
      const int x = rem / G, g = rem - x * G;
      if (w0 + x >= W) continue;
      const Tin* l = lrow + x * ld + g * cpg;
      const Tin* r0 = rwin + (x + D - s_i0[kk]) * ld + g * cpg;
      const Tin* r1 = r0 - ld;
      float a0 = 0.f, a1 = 0.f;
      for (int c = 0; c < cpg; ++c) {
        a0 = fmaf(to_f32(l[c]), to_f32(r0[c]), a0);
        a1 = fmaf(to_f32(l[c]), to_f32(r1[c]), a1);
      }
      const float v = a0 * (s_w0[kk] * inv_cpg) + a1 * (s_w1[kk] * inv_cpg);
      out_bh[kk * slab + (long)(w0 + x) * G + g] = from_f32<Tout>(v);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* left, const void* right,
                   const void* positions, void* out, int B, int H, int W,
                   int C, int G, int K, int D, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Tin);
  const size_t smem =
      (size_t)(kTileW + kTileW + D + 1) * (C + kVec) * sizeof(Tin);
  const bool fast = G % 8 == 0 && C == 2 * G
                    && kThreads % (kTileW * (G / 8)) == 0
                    && aligned16(left) && aligned16(right) && aligned16(out);
  auto kernel = fast ? gwc_warp_kernel<Tin, Tout, true>
                     : gwc_warp_kernel<Tin, Tout, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int wtiles = (W + kTileW - 1) / kTileW;
  const int kchunks = (K + kDepthPerBlock - 1) / kDepthPerBlock;
  const dim3 grid(wtiles * kchunks, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(left), static_cast<const Tin*>(right),
      static_cast<const float*>(positions), static_cast<Tout*>(out), H, W, C,
      G, K, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stereoscene_gwc_warp(const void* left, const void* right,
                                    const void* positions, void* out, int B,
                                    int H, int W, int C, int G, int K, int D,
                                    int in_bf16, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16 && out_bf16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(left, right, positions, out, B,
                                               H, W, C, G, K, D, s);
  } else if (in_bf16) {
    err = launch<__nv_bfloat16, float>(left, right, positions, out, B, H, W,
                                       C, G, K, D, s);
  } else if (out_bf16) {
    err = launch<float, __nv_bfloat16>(left, right, positions, out, B, H, W,
                                       C, G, K, D, s);
  } else {
    err = launch<float, float>(left, right, positions, out, B, H, W, C, G, K,
                               D, s);
  }
  return static_cast<int>(err);
}
