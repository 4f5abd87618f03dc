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
// where the corner lies off the map. Each block derives its pixels' corners
// from the offsets with the fp32 operations of ops/deform_conv.py:
// dcn_corner_tables, which the plain version uses. The offsets are read in
// place, fp32 or bf16 (widened exactly, so the positions equal those of
// offsets.float()), through their four strides: serving's bf16 NCHW head
// output seen as [B, H, W, 2K] goes in with no cast and no copy.
//
// What bounds it on an H100: bytes. At the flagship DepthNet DCN (B = 1,
// 48 x 160, C = 640, K = 9) z is 88.5 MB in bf16, the offsets 0.28 MB and
// the output 9.8 MB: ~30 us at 3.35 TB/s if every z row came from device
// memory once. Each output row gathers 36 z rows; a sample's corners lie
// within a few pixels of it, so the same z rows serve neighbouring pixels.
//
// Design, from the four costs of the one-warp-per-row version:
// - channel slices are the grid's outer axis (blockIdx.y), as the TPU
//   kernel's grid ran 128-lane slices outermost: a block takes one 256-byte
//   slice of z's rows (128 bf16 or 64 fp32 channels) for a 2 x 8 tile of
//   pixels, so the blocks resident together read one slice of z (17.7 MB
//   of bf16 for all 9 taps), which L2 holds. Blocks that walked all the
//   slices of their tile, deriving its corners once, ran bf16 faster but
//   fp32 slower (480 blocks at 3 an SM fill 1.2 waves; PERF.md);
// - every lane does equal work: a half-warp takes one pixel, a lane one
//   16-byte vector of its slice, so each thread gathers exactly one pixel's
//   samples and no thread waits on a chain of pixels (tiles of 4 x 16
//   pixels, four in turn a half-warp, ran slower: the L1 reuse of corner
//   rows they bought was worth less than the parallelism they cost); a C
//   that is not a multiple of the slice leaves a tail slice whose spare
//   lanes stop early;
// - kw is a template parameter, so the 4 * K loads of a pixel unroll and a
//   lane issues them in batches of 8 (bf16) or 12 (fp32) before their FMAs,
//   the batch and the register cap that keep 4 (bf16) or 3 (fp32) blocks
//   resident on an SM;
// - no atomics: each lane writes its 16 bytes of a pixel once, so two
//   launches on equal inputs are bitwise equal. Every corner index is
//   clipped into the map, so no offset can read outside z.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // a half-warp per pixel, 16 bytes a lane
constexpr int kSliceBytes = 16 * kLanes;  // of a z row, a block's slice
constexpr int kTileH = 2;  // image rows of a block's pixel tile
constexpr int kTileW = 8;  // image columns of it
constexpr int kTile = kTileH * kTileW;
static_assert(kTile * kLanes == kThreads, "one pixel per half-warp");
constexpr int kCorners = 4;

// the taps whose corner loads a lane issues at once, and the blocks an SM
// must hold (the register cap that follows)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;  // fp32 per 16-byte vector
  static constexpr int tap_batch = 3;
  static constexpr int min_blocks = 3;
  static __device__ __forceinline__ void widen(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
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
  static constexpr int tap_batch = 2;
  static constexpr int min_blocks = 4;
  static __device__ __forceinline__ void widen(const uint4& q, float* v) {
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

__device__ __forceinline__ float offset_value(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float offset_value(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((unsigned)bits << 16);
}

// z [K, N, C] in T, offsets [B, H, W, 2K] in O with element strides
// (sb, sh, sw, sc), out [N, C] in T; N = B * H * W. Grid: (B * tiles of
// kTileH x kTileW pixels, slices of kSliceBytes of a row).
template <typename T, typename O, int KW>
__global__ void __launch_bounds__(kThreads, Vec<T>::min_blocks)
    dcn_gather_kernel(const T* __restrict__ z, const O* __restrict__ off,
                      T* __restrict__ out, int N, int H, int W, int C,
                      int tiles_w, int tiles_per_image, int sb, int sh,
                      int sw, int sc) {
  constexpr int K = KW * KW;
  constexpr int V = Vec<T>::n;
  constexpr int kSamples = K * kCorners;
  constexpr int kBatch = Vec<T>::tap_batch * kCorners;
  __shared__ int2 s_corner[kTile][kSamples];  // (row, weight bits)

  const int b = blockIdx.x / tiles_per_image;
  const int tile = blockIdx.x - b * tiles_per_image;
  const int tile_y = tile / tiles_w;
  const int y_base = tile_y * kTileH;
  const int x_base = (tile - tile_y * tiles_w) * kTileW;
  const int hw = H * W;

  // one (pixel, tap) sample a thread: its position, floor and four
  // corners, in the order and with the fp32 operations of
  // dcn_corner_tables; consecutive threads take consecutive pixels of a tap
  if (threadIdx.x < K * kTile) {
    const int t = threadIdx.x / kTile;
    const int p = threadIdx.x - t * kTile;
    const int y = y_base + p / kTileW;
    const int x = x_base + p % kTileW;
    if (y < H && x < W) {
      const O* o = off + (size_t)b * sb + (size_t)y * sh + (size_t)x * sw +
                   (size_t)(2 * t) * sc;
      const float half = 0.5f * (float)(KW - 1);
      const float ky = (float)(t / KW) - half;
      const float kx = (float)(t % KW) - half;
      const float sy = ((float)y + ky) + offset_value(o);
      const float sx = ((float)x + kx) + offset_value(o + sc);
      const float y0 = floorf(sy), x0 = floorf(sx);
      const float fy = sy - y0, fx = sx - x0;
      const int y0i = (int)y0, x0i = (int)x0;
      const float wy[2] = {1.f - fy, fy};
      const float wx[2] = {1.f - fx, fx};
#pragma unroll
      for (int c = 0; c < kCorners; ++c) {
        const int yi = y0i + (c >> 1), xi = x0i + (c & 1);
        const bool inside = yi >= 0 && yi < H && xi >= 0 && xi < W;
        const int row =
            min(max(yi, 0), H - 1) * W + min(max(xi, 0), W - 1) + b * hw;
        const float wgt = inside ? wy[c >> 1] * wx[c & 1] : 0.f;
        s_corner[p][t * kCorners + c] = make_int2(row, __float_as_int(wgt));
      }
    }
  }
  __syncthreads();

  // a half-warp per pixel, a lane per 16 bytes of the block's slice
  const int p = threadIdx.x / kLanes;
  const int y = y_base + p / kTileW;
  const int x = x_base + p % kTileW;
  const int c0 = (blockIdx.y * kLanes + threadIdx.x % kLanes) * V;
  if (y >= H || x >= W || c0 >= C) return;  // off the map, or a tail slice
  const size_t tap_stride = (size_t)N * C;
  const T* zc = z + c0;
  const int2* corner = s_corner[p];
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
  for (int s0 = 0; s0 < kSamples; s0 += kBatch) {
    uint4 raw[kBatch];
    float wgt[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (s0 + j < kSamples) {
        const int2 e = corner[s0 + j];
        wgt[j] = __int_as_float(e.y);
        raw[j] = __ldg(reinterpret_cast<const uint4*>(
            zc + (size_t)((s0 + j) / kCorners) * tap_stride +
            (size_t)e.x * C));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (s0 + j < kSamples) {
        float v[V];
        Vec<T>::widen(raw[j], v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(wgt[j], v[e], acc[e]);
      }
    }
  }
  Vec<T>::store(out + ((size_t)b * hw + (size_t)y * W + x) * C + c0, acc);
}

template <typename T, typename O, int KW>
cudaError_t launch(const void* z, const void* off, void* out, int N, int H,
                   int W, int C, int tiles, int slices, int tiles_w, int sb,
                   int sh, int sw, int sc, cudaStream_t stream) {
  const int tiles_per_image = tiles_w * ((H + kTileH - 1) / kTileH);
  dcn_gather_kernel<T, O, KW><<<dim3(tiles, slices), kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const O*>(off),
      static_cast<T*>(out), N, H, W, C, tiles_w, tiles_per_image, sb, sh, sw,
      sc);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_kw(int kw, const void* z, const void* off, void* out,
                      int N, int H, int W, int C, int tiles, int slices,
                      int tiles_w, int sb, int sh, int sw, int sc,
                      cudaStream_t stream) {
  switch (kw) {
    case 1:
      return launch<T, O, 1>(z, off, out, N, H, W, C, tiles, slices, tiles_w,
                             sb, sh, sw, sc, stream);
    case 2:
      return launch<T, O, 2>(z, off, out, N, H, W, C, tiles, slices, tiles_w,
                             sb, sh, sw, sc, stream);
    default:
      return launch<T, O, 3>(z, off, out, N, H, W, C, tiles, slices, tiles_w,
                             sb, sh, sw, sc, stream);
  }
}

}  // namespace

// z [kw * kw, B*H*W, C] (bf16 when z_bf16, else fp32; 16-byte aligned, C a
// multiple of 16 bytes), offsets [B, H, W, 2 * kw * kw] (bf16 when
// offsets_bf16, else fp32) at element strides (s_b, s_h, s_w, s_c), out
// [B*H*W, C] in z's dtype. tiles = B * ceil(H / 2) * ceil(W / 8) and
// slices = ceil(C * element size / 256) are the grid, as
// ops/deform_conv.py: dcn_gather_args computes them; any other value is
// refused.
extern "C" int stereoscene_dcn_gather(const void* z, const void* offsets,
                                      void* out, int B, int H, int W, int C,
                                      int kw, int z_bf16, int offsets_bf16,
                                      int s_b, int s_h, int s_w, int s_c,
                                      int tiles, int slices, void* stream) {
  const int vec = z_bf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  const int slice = kSliceBytes / (z_bf16 ? 2 : 4);  // channels of a slice
  if (kw < 1 || kw > 3 || B < 1 || H < 1 || W < 1 || C < 1 || C % vec ||
      s_b < 0 || s_h < 0 || s_w < 0 || s_c < 0 ||
      (long long)B * H * W > INT_MAX ||
      ((uintptr_t)z | (uintptr_t)out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const long long want_tiles =
      (long long)B * tiles_w * ((H + kTileH - 1) / kTileH);
  if (tiles != want_tiles ||
      slices != (C + slice - 1) / slice || slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (z_bf16) {
    err = offsets_bf16
              ? launch_kw<__nv_bfloat16, __nv_bfloat16>(
                    kw, z, offsets, out, N, H, W, C, tiles, slices, tiles_w,
                    s_b, s_h, s_w, s_c, s)
              : launch_kw<__nv_bfloat16, float>(kw, z, offsets, out, N, H, W,
                                                C, tiles, slices, tiles_w,
                                                s_b, s_h, s_w, s_c, s);
  } else {
    err = offsets_bf16
              ? launch_kw<float, __nv_bfloat16>(kw, z, offsets, out, N, H, W,
                                                C, tiles, slices, tiles_w,
                                                s_b, s_h, s_w, s_c, s)
              : launch_kw<float, float>(kw, z, offsets, out, N, H, W, C,
                                        tiles, slices, tiles_w, s_b, s_h,
                                        s_w, s_c, s);
  }
  return static_cast<int>(err);
}
