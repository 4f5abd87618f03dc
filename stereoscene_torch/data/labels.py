"""SemanticKITTI label mappings, port of ``stereoscene_tpu/data/labels.py``
(a copy: the port imports nothing of the JAX package).

The 34 raw SemanticKITTI label ids collapse to 20 training classes
(0 = empty/unlabeled, 1-19 semantic). Moving-object ids (252-259) fold into
their static classes. This is the ``learning_map`` of the official
semantic-kitti-api (also shipped by the reference as semantickitti.yaml),
vendored as plain dicts so the data layer has no YAML dependency. Also the
MonoScene label downsample and the CRP relation matrix of the training-data
pipeline.
"""

from __future__ import annotations

import numpy as np

LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72, 18: 80,
    19: 81,
}


def remap_lut() -> np.ndarray:
    """Raw-id -> train-id LUT for SSC voxel labels.

    For scene *completion* the raw id 0 means 'empty' and must stay 0, while
    every other id that maps to train-id 0 (unlabeled-ish classes) becomes
    255 (invalid). ref: tools/data_converter/kitti_process/io_data.py:173-194
    """
    maxkey = max(LEARNING_MAP.keys())
    lut = np.zeros((maxkey + 100,), dtype=np.int32)
    lut[list(LEARNING_MAP.keys())] = list(LEARNING_MAP.values())
    lut[lut == 0] = 255
    lut[0] = 0
    return lut


def seg_remap_lut() -> np.ndarray:
    """Raw-id -> train-id LUT for LiDAR point segmentation (0 = ignored)."""
    maxkey = max(LEARNING_MAP.keys())
    lut = np.zeros((maxkey + 100,), dtype=np.int32)
    lut[list(LEARNING_MAP.keys())] = list(LEARNING_MAP.values())
    return lut


def inv_map() -> np.ndarray:
    """Train-id -> raw-id LUT for writing benchmark submissions
    (ref: occupancy/apis/test.py:49-64 save path)."""
    lut = np.zeros((max(LEARNING_MAP_INV) + 1,), dtype=np.uint16)
    for k, v in LEARNING_MAP_INV.items():
        lut[k] = v
    return lut


def downsample_label_monoscene(label: np.ndarray, ds) -> np.ndarray:
    """MonoScene-style label downsampling (ref voxel_labels.py:79-117,
    taken from the SSC codebase): a block is empty/invalid when >95% of its
    voxels are 0 or 255 (whichever is more frequent wins); otherwise the
    majority semantic label (excluding 0 and 255). Vectorized.

    Args:
      label: [X, Y, Z] uint8 labels (0 empty, 255 invalid).
      ds: int or (dx, dy, dz) per-axis downscale factors.
    """
    if np.isscalar(ds):
        ds = (int(ds), int(ds), int(ds))
    dx, dy, dz = ds
    if (dx, dy, dz) == (1, 1, 1):
        return label.copy()
    x, y, z = label.shape
    assert x % dx == 0 and y % dy == 0 and z % dz == 0
    blocks = label.reshape(x // dx, dx, y // dy, dy, z // dz, dz)
    blocks = blocks.transpose(0, 2, 4, 1, 3, 5).reshape(
        x // dx, y // dy, z // dz, dx * dy * dz
    )
    counts = np.apply_along_axis(
        lambda v: np.bincount(v, minlength=256), -1, blocks
    )
    zero_count = counts[..., 0] + counts[..., 255]
    empty_block = zero_count > 0.95 * (dx * dy * dz)
    empty_label = np.where(counts[..., 0] > counts[..., 255], 0, 255)
    sem_major = counts[..., 1:255].argmax(-1) + 1
    return np.where(empty_block, empty_label, sem_major).astype(np.uint8)


def compute_cp_mega_matrix(target: np.ndarray, binary: bool = False
                           ) -> np.ndarray:
    """Context-prior relation ground truth between every voxel and every
    2x2x2 mega-voxel (ref voxel_labels.py:66-176 CreateRelationLabels.
    compute_CP_mega_matrix, vectorized: the reference's triple loop over
    supervoxels becomes 8 broadcast comparisons).

    Args:
      target: [X, Y, Z] semantic labels (0 empty, 255 invalid), with even
        dims.
    Returns:
      [R, N, S] uint8 with R = 2 (binary) or 4 relations, N = X*Y*Z voxels,
      S = (X/2)*(Y/2)*(Z/2) mega voxels. 4-way relations:
      0 same-nonempty / 1 diff-nonempty / 2 both-empty / 3 nonempty-empty.
    """
    x, y, z = target.shape
    assert x % 2 == 0 and y % 2 == 0 and z % 2 == 0
    n = x * y * z
    s = (x // 2) * (y // 2) * (z // 2)
    row = target.reshape(-1).astype(np.int32)[:, None]        # [N, 1]
    corners = target.reshape(x // 2, 2, y // 2, 2, z // 2, 2)
    corners = corners.transpose(0, 2, 4, 1, 3, 5).reshape(s, 8)

    r = 2 if binary else 4
    matrix = np.zeros((r, n, s), np.uint8)
    row_valid = row != 255
    for c in range(8):
        col = corners[:, c].astype(np.int32)[None, :]         # [1, S]
        cv = col != 255
        if binary:
            matrix[0] |= (row_valid & cv & (col != row))
            matrix[1] |= (row_valid & cv & (col == row))
        else:
            matrix[0] |= (row_valid & cv & (col == row) & (col != 0))
            matrix[1] |= (row_valid & cv & (col != row) & (col != 0)
                          & (row != 0))
            matrix[2] |= (row_valid & cv & (row == col) & (col == 0))
            matrix[3] |= (row_valid & cv & (row != col)
                          & ((row == 0) | (col == 0)))
    return matrix
