// Native host-side kernels for the SemanticKITTI data path.
//
// The reference relies on numba JIT for voxel-label majority voting
// (ref: datasets/pipelines/voxel_labels.py:47-63) and pays heavy per-step
// numpy cost for LiDAR depth-map scatter (ref: occ_to_depth.py:297-302) and
// packed voxel-label decoding (ref: io_data.py:10-22). These are the host
// data-loader hot loops; here they are plain C++ with a C ABI consumed via
// ctypes (stereoscene_torch/native/__init__.py). No Python objects cross the
// boundary — only raw buffers.
//
// The port's copy of the JAX package's library source, the same four entry
// points and the same arithmetic. Built at first use by
// stereoscene_torch/native/__init__.py (g++ -O3 -shared -fPIC) into
// stereoscene_torch/_kernels_build/.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Unpack bit-packed invalid mask + remap raw uint16 labels through `lut`,
// writing uint8 train ids (255 = invalid). n = number of voxels.
void unpack_remap_labels(const uint16_t* labels, const uint8_t* invalid_packed,
                         const int32_t* lut, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t byte = invalid_packed[i >> 3];
    const bool invalid = (byte >> (7 - (i & 7))) & 1;
    out[i] = invalid ? 255 : static_cast<uint8_t>(lut[labels[i]]);
  }
}

// Majority-vote k^3 downsample of a [X, Y, Z] uint8 grid, ignoring
// empty(0)/invalid(255) when any semantic label is present.
void majority_downsample(const uint8_t* grid, int64_t X, int64_t Y, int64_t Z,
                         int64_t k, uint8_t* out) {
  const int64_t OX = X / k, OY = Y / k, OZ = Z / k;
  int32_t counts[256];
  for (int64_t ox = 0; ox < OX; ++ox) {
    for (int64_t oy = 0; oy < OY; ++oy) {
      for (int64_t oz = 0; oz < OZ; ++oz) {
        std::memset(counts, 0, sizeof(counts));
        for (int64_t dx = 0; dx < k; ++dx)
          for (int64_t dy = 0; dy < k; ++dy)
            for (int64_t dz = 0; dz < k; ++dz) {
              const uint8_t v = grid[((ox * k + dx) * Y + oy * k + dy) * Z +
                                     oz * k + dz];
              ++counts[v];
            }
        int32_t best_sem = -1, best_cnt = 0;
        for (int c = 1; c < 255; ++c)
          if (counts[c] > best_cnt) { best_cnt = counts[c]; best_sem = c; }
        uint8_t result;
        if (best_sem > 0) result = static_cast<uint8_t>(best_sem);
        else result = counts[0] >= counts[255] ? 0 : 255;
        out[(ox * OY + oy) * OZ + oz] = result;
      }
    }
  }
}

// Nearest-return depth scatter: points (u, v, d) -> [H, W] depth map where
// the smallest positive depth wins per pixel. uvd is [n, 3] float32.
// Also writes a seg map from per-point labels when seg != nullptr.
void scatter_depth(const float* uvd, const float* seg, int64_t n, int64_t H,
                   int64_t W, float* depth_out, float* seg_out) {
  std::memset(depth_out, 0, sizeof(float) * H * W);
  if (seg_out) std::memset(seg_out, 0, sizeof(float) * H * W);
  for (int64_t i = 0; i < n; ++i) {
    const float u = uvd[i * 3], v = uvd[i * 3 + 1], d = uvd[i * 3 + 2];
    if (d <= 0.f) continue;
    const int64_t ui = static_cast<int64_t>(u + 0.5f);
    const int64_t vi = static_cast<int64_t>(v + 0.5f);
    if (ui < 0 || ui >= W || vi < 0 || vi >= H) continue;
    float& slot = depth_out[vi * W + ui];
    if (slot == 0.f || d < slot) {
      slot = d;
      if (seg_out && seg) seg_out[vi * W + ui] = seg[i];
    }
  }
}

// Per-voxel majority vote from labeled points (the numba nb_process_label
// equivalent): points quantized to voxel ids, per-voxel class histogram
// argmax. coords is [n, 3] int32 (assumed in-bounds), labels [n] int32.
void point_majority_vote(const int32_t* coords, const int32_t* labels,
                         int64_t n, int64_t X, int64_t Y, int64_t Z,
                         int32_t num_classes, int32_t* hist_scratch,
                         uint8_t* out) {
  const int64_t V = X * Y * Z;
  std::memset(hist_scratch, 0, sizeof(int32_t) * V * num_classes);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t vid =
        (static_cast<int64_t>(coords[i * 3]) * Y + coords[i * 3 + 1]) * Z +
        coords[i * 3 + 2];
    ++hist_scratch[vid * num_classes + labels[i]];
  }
  for (int64_t v = 0; v < V; ++v) {
    int32_t best = 0, best_cnt = hist_scratch[v * num_classes];
    for (int32_t c = 1; c < num_classes; ++c)
      if (hist_scratch[v * num_classes + c] > best_cnt) {
        best_cnt = hist_scratch[v * num_classes + c];
        best = c;
      }
    out[v] = static_cast<uint8_t>(best);
  }
}

}  // extern "C"
