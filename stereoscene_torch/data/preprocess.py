"""Offline SemanticKITTI voxel-label preprocessing, port of
``stereoscene_tpu/data/preprocess.py`` (a copy: the port imports nothing of
the JAX package). Numpy only: the JAX package's optional native library is
not ported, so the numpy branches below are the port's one route (the JAX
package's tests hold its native kernels to these same numpy formulas).

Rebuild of ``tools/data_converter/kitti_process/semantic_kitti_preprocess.py``
(+ io_data.py): for every frame of sequences 00-10, read the packed voxel
``.label`` (uint16 per voxel) and ``.invalid`` (bit-packed) files, remap raw
ids to the 20 train classes (empty stays 0, unlabeled -> 255), mark invalid
voxels 255, reshape to [256, 256, 32] and save ``<frame>_1_1.npy``.

All array ops are vectorized numpy (the reference's bit unpack loop
io_data.py:10-22 becomes one ``np.unpackbits``).
"""

from __future__ import annotations

import glob
import os
from typing import Iterable, Optional

import numpy as np

from .labels import remap_lut

SCENE_SIZE = (256, 256, 32)
ALL_SEQUENCES = ["00", "01", "02", "03", "04", "05", "06", "07", "08", "09", "10"]


def unpack_bits(compressed: np.ndarray) -> np.ndarray:
    """Bit-packed uint8 array -> one uint8 per bit (MSB first)."""
    return np.unpackbits(compressed.astype(np.uint8))


def read_label_file(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.uint16)


def read_invalid_file(path: str) -> np.ndarray:
    return unpack_bits(np.fromfile(path, dtype=np.uint8))


def process_frame(label_path: str, invalid_path: str) -> np.ndarray:
    """One frame -> [256, 256, 32] uint8 train-id grid (255 = invalid)."""
    lut = remap_lut()
    label = read_label_file(label_path)
    invalid = read_invalid_file(invalid_path)
    out = lut[label.astype(np.uint16)].astype(np.float32)
    out[np.isclose(invalid, 1)] = 255
    return out.reshape(SCENE_SIZE).astype(np.uint8)


def majority_downsample(grid: np.ndarray, k: int = 2) -> np.ndarray:
    """Majority-vote downscale ignoring empty/invalid where possible
    (vectorized version of the reference's majority_pooling,
    semantic_kitti_preprocess.py:73-97)."""
    x, y, z = grid.shape
    blocks = grid[: x - x % k, : y - y % k, : z - z % k]
    blocks = blocks.reshape(x // k, k, y // k, k, z // k, k)
    blocks = blocks.transpose(0, 2, 4, 1, 3, 5).reshape(
        x // k, y // k, z // k, k * k * k
    )
    # counts per label: use 256-bin histogram along last axis
    counts = np.apply_along_axis(
        lambda v: np.bincount(v, minlength=256), -1, blocks
    )
    semantic = counts[..., 1:255]
    has_semantic = semantic.sum(-1) > 0
    sem_major = semantic.argmax(-1) + 1
    # empty (0) vs invalid (255) fallback when no semantic label in the block
    empty_major = np.where(counts[..., 0] >= counts[..., 255], 0, 255)
    return np.where(has_semantic, sem_major, empty_major).astype(np.uint8)


def create_voxel_labels(
    points: np.ndarray,
    labels: np.ndarray,
    grid_shape,
    pc_range,
) -> np.ndarray:
    """Per-voxel majority vote from labeled points (the numba
    ``nb_process_label`` / CreateVoxelLabels equivalent,
    ref: datasets/pipelines/voxel_labels.py:16-63), by a vectorized numpy
    histogram.

    Args:
      points: [N, 3] xyz; labels: [N] int class ids.
    Returns: [X, Y, Z] uint8 majority labels (0 where empty).
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    lo = np.asarray(pc_range[:3], np.float32)
    hi = np.asarray(pc_range[3:], np.float32)
    size = (hi - lo) / np.asarray(grid_shape, np.float32)
    coords = np.floor((points - lo) / size).astype(np.int32)
    valid = np.all((coords >= 0) & (coords < np.asarray(grid_shape)), axis=1)
    coords = coords[valid]
    labels = labels[valid].astype(np.int32)
    num_classes = int(labels.max(initial=0)) + 1

    nx, ny, nz = grid_shape
    vid = (coords[:, 0].astype(np.int64) * ny + coords[:, 1]) * nz + coords[:, 2]
    hist = np.zeros((nx * ny * nz, num_classes), np.int32)
    np.add.at(hist, (vid, labels), 1)
    out = np.where(hist.sum(1) > 0, hist.argmax(1), 0)
    return out.reshape(grid_shape).astype(np.uint8)


def process_sequences(
    kitti_root: str,
    out_root: str,
    sequences: Optional[Iterable[str]] = None,
    scales: Iterable[str] = ("1_1",),
    verbose: bool = True,
) -> int:
    """Run the full preprocessing. Returns number of frames written."""
    written = 0
    for seq in sequences or ALL_SEQUENCES:
        seq_path = os.path.join(kitti_root, "dataset", "sequences", seq)
        label_paths = sorted(glob.glob(os.path.join(seq_path, "voxels", "*.label")))
        invalid_paths = sorted(
            glob.glob(os.path.join(seq_path, "voxels", "*.invalid"))
        )
        out_dir = os.path.join(out_root, "labels", seq)
        os.makedirs(out_dir, exist_ok=True)
        for lp, ip in zip(label_paths, invalid_paths):
            frame_id = os.path.splitext(os.path.basename(lp))[0]
            grid = process_frame(lp, ip)
            for scale in scales:
                out_path = os.path.join(out_dir, f"{frame_id}_{scale}.npy")
                if os.path.exists(out_path):
                    continue
                if scale == "1_1":
                    np.save(out_path, grid)
                else:
                    k = int(scale.split("_")[1])
                    np.save(out_path, majority_downsample(grid, k))
                written += 1
                if verbose and written % 100 == 0:
                    print(f"[preprocess] wrote {written} files (seq {seq})")
    return written
