// 3x3x3 stride-1 pad-1 conv3d as an implicit GEMM (K4).
//
// Replaces stereoscene_tpu/ops/pallas_conv3d.py:80-125 (_conv3d_s1_single
// and its _kernel, public conv3d_s1_pallas). There the TPU kernel DMA'd a
// three-slice halo block of the padded input into VMEM, copied the nine
// (kh, kw) shifted views into an im2col scratch and ran one
// [BH*W, 9*CL] x [9*CL, Co] MXU dot per depth tap. Hopper has no VMEM of
// that size, so the im2col matrix is never built: every K-step copies the
// shifted input rows of one tap straight from the channels-last volume
// into shared memory.
//
// The GEMM, per sample: M = D*H*W output voxels, N = Co, K = 27*Ci.
//   y[m, n] = sum_{tap, ci} x[m shifted by tap, ci] * w[tap, ci, n]
// with zero where the shifted voxel falls outside the volume. No bias.
//
// What bounds it on an H100: operations. At the flagship's 64 -> 64 conv
// at [56, 24, 80] the GEMM is 2 * 107,520 * 64 * 1,728 = 23.8 GFLOP against
// 27.8 MB of bf16 input, output and weights: 856 FLOP per byte, far above
// the card's ~295 FLOP/B ridge (989 TFLOP/s bf16 over 3.35 TB/s). So the
// bf16 route runs on the tensor cores, and the design keeps them fed:
//
// - wgmma.mma_async m64nNk16 (N = BN = 64 or 128), bf16 in, fp32
//   accumulators in registers. A block is two warpgroups, 256 threads,
//   and owns 128 output voxels x BN output channels: each warpgroup
//   multiplies its 64 rows by the block's whole B tile.
// - A K-step is one tap x one 64-channel slice (Ci = 64: 27 steps,
//   Ci = 128: 54). Its A tile is the 128 rows m0 + shift .. m0 + shift +
//   127 of the flat [B*D*H*W, Ci] volume, one contiguous range, so one TMA
//   copy (cp.async.bulk.tensor) brings it; rows off either end of the
//   batch come back as zeros. The rows whose tap falls outside the volume
//   (the previous or next line, slice or sample) are then zeroed by the
//   threads that own them, from a 27-bit mask per row computed once.
//   B is w[tap, n0:n0+BN, c0:c0+64] of the K-major weights [27, Co, Ci],
//   one TMA copy of a 3-D map whose rows past Co read as zeros; the first
//   launch of the call packs them from the conv weight.
// - TMA writes both tiles with the 128-byte swizzle (16-byte chunk j of
//   row r at chunk j ^ (r % 8)), the layout the wgmma descriptors name, so
//   the tensor cores read them without bank conflicts.
// - A ring of 4 (BN = 64) or 5 (BN = 128) stages with one mbarrier each:
//   one thread keeps the copies two or three K-steps ahead of the MMAs,
//   and each warpgroup keeps one K-step of wgmma in flight while the next
//   is issued.
// - The epilogue rounds to bf16, stages the tile in shared memory and
//   stores 16 bytes per thread, coalesced along Co.
//
// A first version of this route copied A and B with 16-byte cp.async
// from every thread; with those copies taken out the same loop ran far
// faster, and reading A without the gather gained little: the copy
// instructions, not the memory, set the pace. TMA moves the same bytes
// with two instructions per K-step.
//
// Tiles (the wrapper picks BN, ops/conv3d.py tile_n; the times of both N
// tiles at these shapes: tools/probe_torch_conv3d_tiles.py):
//   hourglass conv2, 64 -> 64 at 56x24x80: BN = 64 (= Co), 840 blocks,
//     two per SM (97 KB of shared memory each);
//   hourglass conv4, 128 -> 128 at 28x12x40: BN = 128, 105 blocks, under
//     one wave of 132 SMs. Splitting N (BN = 64, 210 blocks) fills the
//     card but is slower: each block then reads A twice;
//   ResNet3D stage 1, 128 -> 128 at 64x64x8: BN = 128, 256 blocks, one per
//     SM (161 KB each).
//
// What it does not do yet: a producer warp with the MMA warpgroups freed
// of the per-step block barrier, and a persistent grid whose next tile's
// copies overlap this tile's epilogue.
//
// The fp32 route is the exact fp32 kernel on the CUDA cores (a 64 x 64
// register-tiled loop whose A tile is a masked gather). The tensor cores'
// TF32 would keep about three decimal digits, which breaks the 1e-4 of
// max|ref| that the fp32 route is held to (its tests, and the fp32 train
// step's gradients against the plain conv).
//
// Layouts: x [B, D, H, W, Ci] and y [B, D, H, W, Co] (a channels_last_3d
// NCDHW tensor is exactly this in memory). bf16: w [Co, Ci, 3, 3, 3]
// (bf16 or fp32) and the packed copy wk [27, Co, Ci], taps in (kd, kh, kw)
// order, Ci a multiple of 64, x 16-byte aligned; fp32: w [27, Ci, Co], Ci
// a multiple of 16. Any Co.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ fp32 route

constexpr int kBM = 64;   // output voxels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) conv3d_s1_fp32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ y, int D, int H, int W, int Ci, int Co) {
  __shared__ float As[kBK][kBM + 1];  // +1: the transposed store is
                                       // free of bank conflicts
  __shared__ float Bs[kBK][kBN];
  __shared__ int sd[kBM], sh[kBM], sw[kBM];

  const long M = (long)D * H * W;
  const long m0 = (long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long b = blockIdx.z;
  const float* xb = x + b * M * Ci;
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
          v = xb[(((long)d * H + h) * W + ww) * Ci + c0 + col];
        As[col][row] = v;
      }
      // B: 16 channels x 64 outputs, 4 per thread, coalesced along Co
      const float* wt = w + ((long)tap * Ci + c0) * Co;
#pragma unroll
      for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
        const int idx = t + r * kThreads;
        const int k = idx / kBN, n = idx % kBN;
        Bs[k][n] = (n0 + n < Co) ? wt[(long)k * Co + n0 + n] : 0.f;
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

  float* yb = y + b * M * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Co) yb[m * Co + n] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------ bf16 route

constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kTcBM = 128;       // output voxels per block, 64 per warpgroup
constexpr int kRowBytes = 128;   // one K-step row: 64 bf16 channels
constexpr int kABytes = kTcBM * kRowBytes;

template <int BN>
struct TcTile {
  static constexpr int kStageBytes = kABytes + BN * kRowBytes;
  // 4 stages where two blocks then fit on an SM (BN = 64), else 5
  static constexpr int kStages = BN == 64 ? 4 : 5;
  // + 1 KB so the ring can start on the 1024-byte boundary the 128-byte
  // swizzle is defined on
  static constexpr int kSmem = kStages * kStageBytes + 1024;
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier and TMA (cp.async.bulk.tensor) helpers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
// the halo rows are zeroed with generic-proxy stores; wgmma reads shared
// memory through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: 128-byte rows, 8-row groups 1024 bytes apart (the stride byte
// offset); the leading byte offset is unused by this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t desc = (uint64_t)((saddr & 0x3FFFF) >> 4);
  desc |= (uint64_t)1 << 16;
  desc |= (uint64_t)(1024 >> 4) << 32;
  desc |= (uint64_t)1 << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_m64n64k16(d, da, db);
  } else {
    wgmma_m64n128k16(d, da, db);
  }
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads, TcTile<BN>::kMinBlocks)
    conv3d_s1_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           __nv_bfloat16* __restrict__ y, int D, int H, int W,
                           int Ci, int Co) {
  using Tile = TcTile<BN>;
  constexpr int kStages = Tile::kStages;
  constexpr int kAhead = kStages - 2;  // K-steps of copies in flight
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];  // one per ring slot
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);

  const int tid = threadIdx.x;
  const long M = (long)D * H * W;
  const long m0 = (long)blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * BN;
  const int row0 = (int)((long)blockIdx.z * M + m0);  // in the [B*M, Ci] map

  // Halo role: thread tid owns 16-byte chunk `chunk` of A rows lrow + 32 i
  // and a mask of the taps whose shifted voxel stays inside the volume.
  // TMA copies each tap's 128 rows as one contiguous range of the flat
  // volume; the rows whose tap falls outside (a neighbouring line, slice
  // or sample, or past either end) are zeroed here after the copy lands.
  const int chunk = tid & 7, lrow = tid >> 3;
  const uint32_t swz = (uint32_t)((chunk ^ (lrow & 7)) << 4);
  uint32_t taps_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + lrow + 32 * i;
    taps_in[i] = 0;  // a row past the end reads zeros at every tap
    if (m < M) {
      const int vw = (int)(m % W), vh = (int)((m / W) % H);
      const int vd = (int)(m / ((long)W * H));
      for (int tap = 0; tap < 27; ++tap) {
        const int d = vd + tap / 9 - 1, h = vh + (tap / 3) % 3 - 1,
                  ww = vw + tap % 3 - 1;
        if ((unsigned)d < (unsigned)D && (unsigned)h < (unsigned)H
            && (unsigned)ww < (unsigned)W)
          taps_in[i] |= 1u << tap;
      }
    }
  }
  const int slices = Ci >> 6;  // 64-channel slices per tap
  const int steps = 27 * slices;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: one TMA copy for A (128 rows x 64 channels of the tap's
  // shifted range) and one for B (BN rows of w[tap, n0:, c0:c0+64]; rows
  // past Co come back as zeros) per K-step
  auto issue = [&](int step) {
    const int slot = step % kStages;
    const uint32_t sa = ring + slot * Tile::kStageBytes;
    const uint32_t bar = smem_addr(&full[slot]);
    const int tap = step / slices;
    const int c0 = (step - tap * slices) << 6;
    const int shift =
        ((tap / 9 - 1) * H + (tap / 3) % 3 - 1) * W + tap % 3 - 1;
    mbar_expect_tx(bar, Tile::kStageBytes);
    tma_load_2d(sa, &map_x, c0, row0 + shift, bar);
    tma_load_3d(sa + kABytes, &map_w, c0, n0, tap, bar);
  };

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kAhead && s < steps; ++s) issue(s);
  }
  // this warpgroup's 64 rows of the A tile
  const uint32_t a_rows = (uint32_t)(tid >> 7) * 64 * kRowBytes;
  for (int step = 0; step < steps; ++step) {
    const int slot = step % kStages;
    const uint32_t sa = ring + slot * Tile::kStageBytes;
    mbar_wait(smem_addr(&full[slot]), (uint32_t)(step / kStages) & 1u);
    const int tap = step / slices;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!((taps_in[i] >> tap) & 1u))
        *reinterpret_cast<uint4*>(ring_ptr + (sa - ring)
                                  + (lrow + 32 * i) * kRowBytes + swz) =
            make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
    // after this barrier the halo rows of `step` are zero, and both
    // warpgroups have retired the wgmma of step - 2, whose slot the copy
    // issued next overwrites
    __syncthreads();
    if (tid == 0 && step + kAhead < steps) issue(step + kAhead);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)  // 16 channels (32 bytes) per wgmma
      wgmma_tile<BN>(acc, sw128_desc(sa + a_rows + 32 * k),
                     sw128_desc(sa + kABytes + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  __syncthreads();

  // Epilogue: the accumulator fragments (row lane / 4 and + 8 of the
  // warp's 16, columns 8 q + 2 (lane % 4) + {0, 1}) go to a bf16 tile in
  // shared memory; a row of it is 16 bytes longer than BN so the fragment
  // stores are free of bank conflicts. Then 16-byte coalesced stores.
  constexpr int kLd = BN + 8;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(ring_ptr);
  const int lane = tid & 31;
  const int r0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = q * 8 + (lane & 3) * 2;
    *reinterpret_cast<__nv_bfloat162*>(stage + r0 * kLd + col) =
        __floats2bfloat162_rn(acc[4 * q], acc[4 * q + 1]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8) * kLd + col) =
        __floats2bfloat162_rn(acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();
  __nv_bfloat16* yb = y + (long)blockIdx.z * M * Co;
  const bool vec = (Co & 7) == 0;  // 16-byte aligned rows
  constexpr int kChunks = BN / 8;
  for (int i = tid; i < kTcBM * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const long m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= Co) continue;
    const __nv_bfloat16* src = stage + r * kLd + c;
    __nv_bfloat16* dst = yb + m * Co + n;
    if (vec && n + 8 <= Co) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < Co; ++e) dst[e] = src[e];
    }
  }
}

// [Co, Ci, 27] -> [27, Co, Ci]: the K-major B operand, bf16
template <typename Tw>
__global__ void pack_weight_kernel(const Tw* __restrict__ w,
                                   __nv_bfloat16* __restrict__ wk, int Ci,
                                   int Co) {
  const long total = 27L * Co * Ci;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int c = (int)(i % Ci);
    const long rest = i / Ci;
    const int n = (int)(rest % Co), tap = (int)(rest / Co);
    wk[i] = __float2bfloat16((float)w[((long)n * Ci + c) * 27 + tap]);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A row-major bf16 tensor of `rank` dims (innermost first) with 128-byte
// swizzled boxes; elements outside it read as zeros
bool encode_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const auto encode = tensor_map_encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr
         && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                   const_cast<void*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
                == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* wk, void* y, int B,
                         int D, int H, int W, int Ci, int Co,
                         cudaStream_t s) {
  using Tile = TcTile<BN>;
  const long M = (long)D * H * W;
  if ((long)B * M + 2L * H * W >= (1L << 31)) return cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)Ci, (cuuint64_t)(B * M)};
  const cuuint64_t x_strides[1] = {(cuuint64_t)Ci * 2};
  const cuuint32_t x_box[2] = {64, kTcBM};
  const cuuint64_t w_dims[3] = {(cuuint64_t)Ci, (cuuint64_t)Co, 27};
  const cuuint64_t w_strides[2] = {(cuuint64_t)Ci * 2,
                                   (cuuint64_t)Ci * Co * 2};
  const cuuint32_t w_box[3] = {64, BN, 1};
  if (!encode_map(&map_x, x, 2, x_dims, x_strides, x_box)
      || !encode_map(&map_w, wk, 3, w_dims, w_strides, w_box))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_s1_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + kTcBM - 1) / kTcBM),
                  (unsigned)((Co + BN - 1) / BN), (unsigned)B);
  conv3d_s1_wgmma_kernel<BN><<<grid, kTcThreads, Tile::kSmem, s>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(y), D, H, W, Ci, Co);
  return cudaGetLastError();
}

}  // namespace

// bf16: w is the conv weight [Co, Ci, 3, 3, 3] (bf16, or fp32 when
// w_fp32), packed into wk [27, Co, Ci] by a first launch; block_n (64 or
// 128) is the N tile. fp32: w is [27, Ci, Co]; wk and block_n are unused.
extern "C" int stereoscene_conv3d_s1(const void* x, const void* w, void* wk,
                                     void* y, int B, int D, int H, int W,
                                     int Ci, int Co, int bf16, int w_fp32,
                                     int block_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (Ci % 64 != 0 || (block_n != 64 && block_n != 128))
      return (int)cudaErrorInvalidValue;
    const int pack_blocks = (int)((27L * Co * Ci + 255) / 256);
    if (w_fp32) {
      pack_weight_kernel<float><<<pack_blocks, 256, 0, s>>>(
          static_cast<const float*>(w), static_cast<__nv_bfloat16*>(wk), Ci,
          Co);
    } else {
      pack_weight_kernel<__nv_bfloat16><<<pack_blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(wk), Ci, Co);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (block_n == 64)
      return (int)launch_wgmma<64>(x, wk, y, B, D, H, W, Ci, Co, s);
    return (int)launch_wgmma<128>(x, wk, y, B, D, H, W, Ci, Co, s);
  }
  if (Ci % kBK != 0) return (int)cudaErrorInvalidValue;
  const long M = (long)D * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM),
                  (unsigned)((Co + kBN - 1) / kBN), (unsigned)B);
  conv3d_s1_fp32_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), D, H, W, Ci, Co);
  return (int)cudaGetLastError();
}
