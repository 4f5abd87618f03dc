"""SemanticKITTI label mappings, port of ``stereoscene_tpu/data/labels.py``
(a copy: the port imports nothing of the JAX package).

The 34 raw SemanticKITTI label ids collapse to 20 training classes
(0 = empty/unlabeled, 1-19 semantic). Moving-object ids (252-259) fold into
their static classes. This is the ``learning_map`` of the official
semantic-kitti-api (also shipped by the reference as semantickitti.yaml),
vendored as plain dicts so the data layer has no YAML dependency. The
MonoScene label downsample and the CRP relation matrix belong to the
training-data pipeline and are not ported yet.
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
