// Lift-splat voxel reduction over a host-built sorted splat plan (K2/K3).
//
// Replaces two Pallas kernels with one chunked design and two entry points:
//   stereoscene_splat_fused  <- stereoscene_tpu/ops/pallas_splat_fused.py
//       (fused_splat_sorted / _fused_kernel): the lift happens inside the
//       kernel. Plan row i contributes dp[order[i]] * feat[order[i] % HW, :],
//       gathered from the [D*fH*fW] depth table and the [fH*fW, C] feature
//       table; rows with order >= P (= D*fH*fW, the grouped plan's pad
//       sentinel) are masked.
//   stereoscene_splat_sorted <- stereoscene_tpu/ops/pallas_splat.py
//       (_splat_sorted_impl / _splat_kernel): a segment sum of rank-sorted
//       value rows vals[i, :]; rows with rank >= num_voxels are pads.
//
// Voxel v owns the plan rows [bounds[v]*group, bounds[v+1]*group). The TPU
// kernels turned the scatter into one-hot matmuls on the MXU because Mosaic
// had no row gather; on Hopper the gather is a plain load.
//
// What bounds it on an H100, at the flagship group-8 plan (547,840 plan
// rows, 496,736 of them in 23,471 of the 32,768 voxels of the 64x64x8 grid,
// 128 channels): K3 moves few DRAM bytes (the 16.8 MB output and the 2.2 MB
// order array); its 413,966 live rows gather 212 MB of fp32 feature rows
// (106 MB in bf16) from a table of 3.9 MB that stays in the 50 MB L2, so
// the count of gathers in flight, not DRAM, sets its pace. K2 streams
// 234 MB of value rows once: a bandwidth kernel. The voxels are very
// uneven: most hold ~20 rows, the longest 1,360, and 9,297 hold none; one
// warp per voxel waited on its longest voxel's 1,360 rows one by one.
//
// Design: balanced row chunks, not one warp per voxel.
//   1. splat_chunks: warp w takes the plan rows [w*chunk_rows,
//      (w+1)*chunk_rows), finds the voxel of its first row by a 32-way
//      search in bounds, keeps the next 32 boundaries in registers, and
//      sums each voxel's run in fp32 registers in plan order. A voxel
//      that begins and ends inside the chunk goes straight to out; a
//      voxel that crosses the chunk's start leaves its sum in the chunk's
//      "head" partial slot, one that begins in the chunk and crosses its
//      end in the "tail" slot.
//   2. splat_fixup: one warp per voxel. An empty voxel gets zeros; a voxel
//      whose rows span chunks cb..ce gets tail[cb] + head[cb+1] + ... +
//      head[ce], added in chunk order. No float atomics anywhere, so two
//      runs are bitwise equal.
//   K2 first derives bounds from its sorted ranks (splat_bounds, a binary
//   search per voxel: torch.searchsorted's left side).
// Memory-level parallelism: for K3 the 32 lanes load 32 order entries at
// once, two batches ahead of the rows they feed, and their 32 depth weights
// one batch ahead; the warp walks the batch passing each row's table index
// and weight by __shfl_sync, kUnroll 16-byte loads per lane in flight. With
// fp32 tables lane l holds channels 4l..4l+3 of a 128-channel pass; with
// bf16 tables (serving's dtype, widened exactly in the kernel) a row is 256
// bytes, so each half-warp takes one row of a pair, 8 channels a lane, and
// the halves' sums meet by __shfl_xor_sync when a voxel ends. K2 streams
// its rows with 16-byte loads, kUnroll rows in flight. C not a multiple of
// 4 (fp32) or 8 (bf16), or an unaligned table, takes the same walk with
// scalar loads.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // 16-byte loads in flight per lane (divides 16)
constexpr int kPass = 128;   // channels per warp pass
constexpr unsigned kFull = 0xffffffffu;

// bf16 (kept as its 16 bits) widened to fp32: exact.
__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const unsigned short* p) {
  return widen(__ldg(p));
}

// A lane's 16-byte share of a table row: 4 fp32 channels, or 8 bf16 ones
// kept as raw bits until they are added (a bf16 row of 128 channels is 256
// bytes, so one warp-wide load fetches two rows).
template <typename T> struct Pack;
template <> struct Pack<float> {
  using type = float4;
  static constexpr int kCh = 4;
};
template <> struct Pack<unsigned short> {
  using type = uint4;
  static constexpr int kCh = 8;
};

// Channels cb..cb+kCh-1 of a row, zeros past C. kVec: C % kCh == 0 and the
// table 16-byte aligned, so cb < C means the whole share is in the row.
template <bool kVec, bool kStream>
__device__ __forceinline__ float4 load_pack(const float* row, int cb, int C) {
  if (kVec) {
    if (cb >= C) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* p = reinterpret_cast<const float4*>(row + cb);
    return kStream ? __ldcs(p) : __ldg(p);
  }
  float4 x;
  x.x = cb < C ? __ldg(row + cb) : 0.f;
  x.y = cb + 1 < C ? __ldg(row + cb + 1) : 0.f;
  x.z = cb + 2 < C ? __ldg(row + cb + 2) : 0.f;
  x.w = cb + 3 < C ? __ldg(row + cb + 3) : 0.f;
  return x;
}

template <bool kVec, bool kStream>
__device__ __forceinline__ uint4 load_pack(const unsigned short* row, int cb,
                                           int C) {
  if (kVec) {
    if (cb >= C) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(row + cb));
  }
  unsigned h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = cb + k < C ? __ldg(row + cb + k) : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                    h[6] | h[7] << 16);
}

__device__ __forceinline__ void fma_pack(float (&acc)[4], float w,
                                         float4 x) {
  acc[0] = fmaf(w, x.x, acc[0]);
  acc[1] = fmaf(w, x.y, acc[1]);
  acc[2] = fmaf(w, x.z, acc[2]);
  acc[3] = fmaf(w, x.w, acc[3]);
}

// bf16 widened to fp32 exactly: its bits are the high half of the float.
__device__ __forceinline__ void fma_pack(float (&acc)[8], float w, uint4 x) {
  const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] = fmaf(w, __uint_as_float(u[k] << 16), acc[2 * k]);
    acc[2 * k + 1] = fmaf(w, __uint_as_float(u[k] & 0xffff0000u),
                          acc[2 * k + 1]);
  }
}

template <bool kVec, int kCh>
__device__ __forceinline__ void store_acc(float* row, int cb, int C,
                                          const float (&acc)[kCh]) {
  if (kVec) {
    if (cb < C) {
#pragma unroll
      for (int k = 0; k < kCh; k += 4)
        *reinterpret_cast<float4*>(row + cb + k) =
            make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kCh; ++k)
    if (cb + k < C) row[cb + k] = acc[k];
}

// The voxel that owns group row g, bounds[0] <= g < bounds[num_voxels]:
// the last v with bounds[v] <= g (empty voxels are skipped). A 32-way
// search: each round the lanes probe 32 points of the interval at once, so
// 32,768 voxels take 3 dependent loads, not 15.
__device__ __forceinline__ int warp_voxel_of(const int* bounds,
                                             int num_voxels, int g,
                                             int lane) {
  int lo = 0, hi = num_voxels;  // the voxel is in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool le = p < hi && __ldg(bounds + p) <= g;
    lo += (__popc(__ballot_sync(kFull, le)) - 1) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// One warp's work on chunk `chunk` of chunk_rows plan rows (see the
// header). Row indices are int: the C entry refuses plans of 2^31 rows.
template <bool kFused, bool kVec, typename T>
__device__ __forceinline__ void splat_chunk(
    const T* __restrict__ src,        // fused: dp [P]; sorted: vals [rows, C]
    const T* __restrict__ feat,       // fused: [HW, C]
    const int* __restrict__ order,    // fused: [rows]
    const int* __restrict__ bounds,   // [num_voxels + 1]
    float* __restrict__ out,          // [num_voxels, C]
    float* __restrict__ partials,     // [n_chunks, 2, C]: head, tail
    int num_voxels, int C, int group, int P, int HW, int chunk_rows,
    int chunk, int lane) {
  const int s = chunk * chunk_rows;
  const int e = s + chunk_rows;
  const int r_lo = max(s, __ldg(bounds) * group);
  const int r_hi = min(e, __ldg(bounds + num_voxels) * group);
  if (r_lo >= r_hi) return;  // only pad rows, or past the plan's voxels

  // K3: lane l's plan row of a 32-row batch, as an order entry (P, the
  // pad sentinel, past the chunk); the first two batches are loaded before
  // the voxel search, whose loads they do not wait for.
  auto order_at = [&](int r) { return r < r_hi ? __ldg(order + r) : P; };
  int o_first = P, o_second = P;
  if (kFused) {
    o_first = order_at(r_lo + lane);
    o_second = order_at(r_lo + 32 + lane);
  }
  const int v_first = warp_voxel_of(bounds, num_voxels, r_lo / group, lane);

  // kR rows per warp-wide load: a row's kPass channels take 32 / kR lanes
  // of kCh channels each; lane `half` of a pair holds row j + half.
  constexpr int kCh = Pack<T>::kCh;
  constexpr int kR = kCh / 4;
  const int half = lane / (32 / kR);
  const int sub = lane % (32 / kR);

  for (int c0 = 0; c0 < C; c0 += kPass) {
    const int cb = c0 + kCh * sub;
    // A window of voxel boundaries in registers: lane i holds
    // bounds[base + i] * group, so walking from voxel to voxel costs
    // shuffles, not dependent loads; reloaded past 31 voxels.
    int base = v_first;
    int win = __ldg(bounds + min(base + lane, num_voxels)) * group;
    auto row_bound = [&](int vv) { return __shfl_sync(kFull, win, vv - base); };
    int v = v_first;
    int v_begin = row_bound(v);
    int v_end = row_bound(v + 1);
    float acc[kCh];
#pragma unroll
    for (int k = 0; k < kCh; ++k) acc[k] = 0.f;

    // The voxel's sum (both halves' for bf16) goes to out when the chunk
    // holds all of its rows, else to the chunk's head (voxel began before
    // s) or tail slot.
    auto flush = [&]() {
      if (kR == 2) {
#pragma unroll
        for (int k = 0; k < kCh; ++k)
          acc[k] += __shfl_xor_sync(kFull, acc[k], 16);
      }
      float* dst;
      if (v_begin >= s && v_end <= e) {
        dst = out + (size_t)v * C;
      } else {
        dst = partials + ((size_t)chunk * 2 + (v_begin < s ? 0 : 1)) * C;
      }
      if (half == 0) store_acc<kVec, kCh>(dst, cb, C, acc);
#pragma unroll
      for (int k = 0; k < kCh; ++k) acc[k] = 0.f;
    };

    // K3: each batch's table rows (-1: masked pad) and weights are loaded
    // one batch ahead, its order entries two batches ahead.
    int o_next = o_second, row_next = -1;
    float w_next = 0.f;
    if (kFused && o_first < P) {
      w_next = load1(src + o_first);
      row_next = o_first % HW;
    }
    for (int r0 = r_lo; r0 < r_hi; r0 += 32) {
      const int n = min(32, r_hi - r0);
      const int row_cur = row_next;
      const float w_cur = w_next;
      if (kFused) {
        row_next = -1;
        w_next = 0.f;
        if (o_next < P) {
          w_next = load1(src + o_next);
          row_next = o_next % HW;
        }
        o_next = order_at(r0 + 64 + lane);
      }
      // kUnroll loads in flight (kUnroll * kR rows) whatever the voxel
      // boundaries among them; j + kR * u + half < 32 always
      for (int j = 0; j < n; j += kUnroll * kR) {
        typename Pack<T>::type x[kUnroll];
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jr = j + kR * u + half;  // this lane's row
          const bool ok = jr < n;
          if (kFused) {
            const int row = __shfl_sync(kFull, row_cur, jr);
            w[u] = __shfl_sync(kFull, w_cur, jr);
            x[u] = ok && row >= 0
                       ? load_pack<kVec, false>(feat + (size_t)row * C, cb, C)
                       : typename Pack<T>::type{};
          } else {
            w[u] = 1.f;  // fmaf(1, x, acc) == acc + x
            x[u] = ok ? load_pack<kVec, true>(src + (size_t)(r0 + jr) * C,
                                              cb, C)
                      : typename Pack<T>::type{};
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int h = 0; h < kR; ++h) {
            const int jj = j + kR * u + h;  // the same for the whole warp
            if (jj < n) {  // predicated, not a break: x stays in registers
              const int r = r0 + jj;
              if (r == v_end) {  // voxel v ends before row r
                flush();
                do {  // the next voxel with rows
                  ++v;
                  if (v + 1 - base > 31) {
                    base = v;
                    win = __ldg(bounds + min(base + lane, num_voxels)) *
                          group;
                  }
                } while (row_bound(v + 1) <= r);
                v_begin = row_bound(v);
                v_end = row_bound(v + 1);
              }
              if (half == h) fma_pack(acc, w[u], x[u]);
            }
          }
        }
      }
    }
    flush();  // the voxel open at the chunk's end (or ending with it)
  }
}

// An explicit minimum of one block per SM leaves ptxas the registers to
// keep every load in flight without spilling (it spilled without it).
template <bool kFused, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads, 1) splat_chunks(
    const T* __restrict__ src, const T* __restrict__ feat,
    const int* __restrict__ order, const int* __restrict__ bounds,
    float* __restrict__ out, float* __restrict__ partials, int num_voxels,
    int C, int group, int P, int HW, int chunk_rows, int n_chunks) {
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk < n_chunks) {
    splat_chunk<kFused, kVec, T>(src, feat, order, bounds, out, partials,
                                 num_voxels, C, group, P, HW, chunk_rows,
                                 chunk, threadIdx.x & 31);
  }
}

// One warp per voxel: zeros for an empty voxel, the chunk-ordered sum of
// its partials for a voxel whose rows span chunks; the rest is written.
__global__ void __launch_bounds__(kThreads) splat_fixup(
    const int* __restrict__ bounds, const float* __restrict__ partials,
    float* __restrict__ out, int num_voxels, int C, int group,
    int chunk_rows) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= num_voxels) return;
  const int b = bounds[v] * group;
  const int e = bounds[v + 1] * group;
  float* dst = out + (size_t)v * C;
  if (b >= e) {
    for (int c = lane; c < C; c += 32) dst[c] = 0.f;
    return;
  }
  const int cb = b / chunk_rows, ce = (e - 1) / chunk_rows;
  if (cb == ce) return;
  for (int c = lane; c < C; c += 32) {
    float sum = partials[((size_t)cb * 2 + 1) * C + c];
    for (int q = cb + 1; q <= ce; ++q)
      sum += partials[((size_t)q * 2) * C + c];
    dst[c] = sum;
  }
}

// K2's bounds from its sorted ranks: bounds[v] = the first row whose rank
// is >= v, for v in [0, num_voxels] (torch.searchsorted, left side).
__global__ void splat_bounds(const int* __restrict__ ranks, int rows,
                             int num_voxels, int* __restrict__ bounds) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v > num_voxels) return;
  int lo = 0, hi = rows;  // ranks[i] < v for i < lo; >= v for i >= hi
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ranks + mid) < v) lo = mid + 1; else hi = mid;
  }
  bounds[v] = lo;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <bool kFused, typename T>
int launch(const T* src, const T* feat, const int* order, const int* bounds,
           float* partials, float* out, int num_voxels, int C, int group,
           int P, int HW, int rows, int chunk_rows, cudaStream_t stream) {
  if (num_voxels <= 0 || C <= 0 || group <= 0 || chunk_rows <= 0 ||
      rows < 0 || (long long)rows + chunk_rows > INT_MAX - 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (rows + chunk_rows - 1) / chunk_rows;
  if (n_chunks > 0) {
    const bool vec = C % Pack<T>::kCh == 0 &&
                     aligned(kFused ? feat : src, 16) && aligned(out, 16) &&
                     aligned(partials, 16);
    const auto kernel = vec ? splat_chunks<kFused, true, T>
                            : splat_chunks<kFused, false, T>;
    kernel<<<(n_chunks + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        src, feat, order, bounds, out, partials, num_voxels, C, group, P, HW,
        chunk_rows, n_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  splat_fixup<<<(num_voxels + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      bounds, partials, out, num_voxels, C, group, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partials: [ceil(rows / chunk_rows), 2, C] fp32 scratch; rows: order's
// length (the padded plan); bf16: dp and feat are bf16 (else fp32), widened
// exactly in the kernel; out is fp32 either way.
extern "C" int stereoscene_splat_fused(const void* dp, const void* feat,
                                       const void* order, const void* bounds,
                                       void* partials, void* out,
                                       int num_voxels, int C, int group,
                                       int P, int HW, int rows,
                                       int chunk_rows, int bf16,
                                       void* stream) {
  const int* o = static_cast<const int*>(order);
  const int* b = static_cast<const int*>(bounds);
  float* part = static_cast<float*>(partials);
  float* y = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B = unsigned short;
    return launch<true>(static_cast<const B*>(dp), static_cast<const B*>(feat),
                        o, b, part, y, num_voxels, C, group, P, HW, rows,
                        chunk_rows, s);
  }
  return launch<true>(static_cast<const float*>(dp),
                      static_cast<const float*>(feat), o, b, part, y,
                      num_voxels, C, group, P, HW, rows, chunk_rows, s);
}

// bounds: [num_voxels + 1] int32 scratch the entry fills from the ranks;
// partials as above.
extern "C" int stereoscene_splat_sorted(const void* vals, const void* ranks,
                                        void* bounds, void* partials,
                                        void* out, int num_voxels, int C,
                                        int rows, int chunk_rows,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_voxels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  splat_bounds<<<(num_voxels + 1 + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(ranks), rows, num_voxels,
      static_cast<int*>(bounds));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<false, float>(
      static_cast<const float*>(vals), nullptr, nullptr,
      static_cast<const int*>(bounds), static_cast<float*>(partials),
      static_cast<float*>(out), num_voxels, C, 1, 0, 1, rows, chunk_rows, s);
}
