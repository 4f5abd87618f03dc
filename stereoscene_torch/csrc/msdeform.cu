// 3D multi-scale deformable attention, forward (msdeform_attn_3d).
//
// Replaces no Pallas kernel: the JAX package samples with XLA gathers
// (stereoscene_tpu/ops/msdeform_attn.py). The reference calls a CUDA
// MSDeformAttn here; this is its trilinear form, as the Mask2Former pixel
// decoder (models/mask2former_occ.py) calls it. Per query q, head h, level
// l and point p:
//
//   pos = loc[b, q, h, l, p] * (X_l, Y_l, Z_l) - 0.5
//   out[b, q, h, :] += attn[b, q, h, l, p] * sum over the 8 corners c of
//                      pos that lie inside level l of w_c * value[b, row_c, h, :]
//
// w_c the trilinear weight, row_c = start_l + (cx * Y_l + cy) * Z_l + cz
// (levels flattened X-outermost), head h owning channels [h * ch, (h+1) * ch).
// The corner and attention weights are multiplied in fp32 in the plain
// route's order; a corner outside its level is skipped, not read; the sum
// over every level, point and corner is fp32 and the output is rounded once
// to the values' dtype. The plain route (ops/msdeform_attn.py _sample_level)
// rounds the folded weights to bf16 and adds the levels in bf16: that
// rounding is the only difference.
//
// What bounds it on an H100: at the m2f cell's shapes (37,376 queries, 8
// heads, 3 levels, 4 points, C = 192, bf16) a call reads 14.3 MB of values,
// 43.1 MB of fp32 locations and 7.2 MB of weights and writes 14.3 MB: 23.6 us
// at 3.35 TB/s, against 1.38 GFLOP (1.4 us). The values fit the 50 MB L2, so
// the corner reads are L2 and L1 traffic: 8 corners x 12 samples x 384 bytes
// a query, about 1.4 GB a call served from the caches. On an H100 80GB HBM3
// at 700 W a call takes about 0.22 ms with locations spread as the m2f
// cell's (11% of the bound), and about 0.13 ms with every location alike
// (all L1 hits): the instructions for 96 corners x 24 channels of fused
// multiply-adds a (query, head) set half the time, the 32-byte sector reads
// from L2 the rest.
//
// Design: one thread per (b, q, h) at the cell's widths, so the location,
// the corners and their weights are worked out once for the head's whole
// row. A thread takes SG slices of V channels of its head, one load of a
// corner's slice each: bf16 with ch a multiple of 24 and 16-byte aligned
// pointers (the m2f cell: ch = 24) takes V = 8, SG = 3, three 16-byte loads
// a corner; every other width, and fp32, takes V = 1, SG = 1, a thread per
// channel.
// The corners go in two groups of 4, their 4 x SG loads in flight together;
// neighbouring queries sample overlapping corners, which L1 and L2 serve.
// A thread per slice instead (three a head at ch = 24) ran at twice the time:
// it repeated the per-sample work three times and kept fewer loads in flight.
// The level table (X, Y, Z, first row; at most 4 levels) comes in as kernel
// arguments, so no device tensor is built for it.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
  int x[kMaxLevels], y[kMaxLevels], z[kMaxLevels], start[kMaxLevels];
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// acc[k] += w * v[k] over one slice. A bf16 pair comes out of its 32-bit
// word with one shift or one mask each, where converting element by element
// took twice the kernel's time at the cell's shapes.
template <int V>
__device__ __forceinline__ void fma_slice(float* acc, float w,
                                          const Pack<float, V>& v) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] += w * v.v[k];
}
template <int V>
__device__ __forceinline__ void fma_slice(float* acc, float w,
                                          const Pack<__nv_bfloat16, V>& v) {
  if constexpr (V % 2 == 0) {
    const unsigned* u = reinterpret_cast<const unsigned*>(&v);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {  // element 2k in the low half
      acc[2 * k] += w * __uint_as_float(u[k] << 16);
      acc[2 * k + 1] += w * __uint_as_float(u[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += w * __bfloat162float(v.v[k]);
  }
}

// The pixel coordinate of a location along an axis of n cells, rounded as
// the plain route rounds loc * n - 0.5 (no fused multiply-add): its lower
// corner i0 and the weights of the lower and upper corners, 1 - frac and
// frac. False where neither corner lies inside (and for NaN).
__device__ __forceinline__ bool axis(float loc, int n, int& i0, float* w) {
  const float pos = __fsub_rn(__fmul_rn(loc, static_cast<float>(n)), 0.5f);
  if (!(pos > -1.0f && pos < static_cast<float>(n))) return false;
  const float base = floorf(pos);
  i0 = static_cast<int>(base);
  w[1] = __fsub_rn(pos, base);
  w[0] = __fsub_rn(1.0f, w[1]);
  return true;
}

template <typename T, int V, int SG>
__global__ void __launch_bounds__(kThreads) msdeform3d_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const T* __restrict__ attn, T* __restrict__ out, int N, int Q, int H,
    int ch, int L, int P, int groups, long long total, Levels lv) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (t >= total) return;
  const int g = static_cast<int>(t % groups);  // this thread's SG slices
  const long long bqh = t / groups;             // (b * Q + q) * H + h
  const int h = static_cast<int>(bqh % H);
  const long long bq = bqh / H;
  const long long b = bq / Q;
  const int C = H * ch;
  const int c_first = h * ch + g * SG * V;
  const T* vhead = value + b * N * C + c_first;
  const float* lp = loc + bqh * L * P * 3;
  const T* ap = attn + bqh * L * P;

  float acc[SG][V];
#pragma unroll
  for (int s = 0; s < SG; ++s) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[s][k] = 0.0f;
  }
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {  // constant indices into lv
    if (l >= L) break;
    const int X = lv.x[l], Y = lv.y[l], Z = lv.z[l];
    const T* vlevel = vhead + static_cast<long long>(lv.start[l]) * C;
    for (int p = 0; p < P; ++p, lp += 3) {
      int x0, y0, z0;
      float wx[2], wy[2], wz[2];
      if (!axis(lp[0], X, x0, wx) || !axis(lp[1], Y, y0, wy) ||
          !axis(lp[2], Z, z0, wz)) {
        continue;
      }
      const float a = to_float(ap[l * P + p]);
#pragma unroll
      for (int c0 = 0; c0 < 8; c0 += 4) {
        Pack<T, V> v[4][SG];
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
          const int cx = x0 + dx, cy = y0 + dy, cz = z0 + dz;
          const bool inside = cx >= 0 && cx < X && cy >= 0 && cy < Y &&
                              cz >= 0 && cz < Z;
          w[j] = inside ? __fmul_rn(__fmul_rn(__fmul_rn(wx[dx], wy[dy]),
                                              wz[dz]), a)
                        : 0.0f;
          if (inside) {
            const Pack<T, V>* row = reinterpret_cast<const Pack<T, V>*>(
                vlevel + ((static_cast<long long>(cx) * Y + cy) * Z + cz) * C);
#pragma unroll
            for (int s = 0; s < SG; ++s) v[j][s] = row[s];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (w[j] != 0.0f) {
#pragma unroll
            for (int s = 0; s < SG; ++s) fma_slice(acc[s], w[j], v[j][s]);
          }
        }
      }
    }
  }
  Pack<T, V>* orow = reinterpret_cast<Pack<T, V>*>(out + bq * C + c_first);
#pragma unroll
  for (int s = 0; s < SG; ++s) {
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.v[k] = from_float<T>(acc[s][k]);
    orow[s] = o;
  }
}

template <typename T, int V, int SG>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, int B, int N, int Q, int H, int ch, int L, int P,
                   const Levels& lv, cudaStream_t stream) {
  const int groups = ch / V / SG;
  const long long total = static_cast<long long>(B) * Q * H * groups;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  msdeform3d_kernel<T, V, SG><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const T*>(attn), static_cast<T*>(out), N, Q, H, ch, L, P,
      groups, total, lv);
  return cudaGetLastError();
}

}  // namespace

// value [B, N, C], loc [B, Q, H, L, P, 3] fp32, attn [B, Q, H, L, P] and out
// [B, Q, C] in the values' dtype (bf16 when bf16 != 0, else fp32), all
// contiguous, C = H * ch; then (X, Y, Z, first row) of each of the L levels,
// level after level, 4 levels' worth (those past L are ignored).
extern "C" int stereoscene_msdeform3d(
    const void* value, const void* loc, const void* attn, void* out, int B,
    int N, int Q, int H, int ch, int L, int P, int bf16, int x0, int y0,
    int z0, int s0, int x1, int y1, int z1, int s1, int x2, int y2, int z2,
    int s2, int x3, int y3, int z3, int s3, void* stream) {
  const Levels lv = {{x0, x1, x2, x3}, {y0, y1, y2, y3}, {z0, z1, z2, z3},
                     {s0, s1, s2, s3}};
  if (B < 1 || N < 1 || Q < 1 || H < 1 || ch < 1 || P < 1 || L < 1 ||
      L > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < L; ++l) {
    if (lv.x[l] < 1 || lv.y[l] < 1 || lv.z[l] < 1 || lv.start[l] < 0 ||
        static_cast<long long>(lv.x[l]) * lv.y[l] * lv.z[l] + lv.start[l] >
            N) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(value) |
                         reinterpret_cast<uintptr_t>(out);
  cudaError_t err;
  if (bf16 && ch % 24 == 0 && ptrs % 16 == 0) {
    err = launch<__nv_bfloat16, 8, 3>(value, loc, attn, out, B, N, Q, H, ch,
                                      L, P, lv, s);
  } else if (bf16) {
    err = launch<__nv_bfloat16, 1, 1>(value, loc, attn, out, B, N, Q, H, ch,
                                      L, P, lv, s);
  } else {
    err = launch<float, 1, 1>(value, loc, attn, out, B, N, Q, H, ch, L, P,
                              lv, s);
  }
  return static_cast<int>(err);
}
