"""3D box core and detection scoring (port of ``stereoscene_tpu/core/``)."""

from .bbox3d import (
    HungarianAssigner3D,
    bbox3d_l1_cost,
    decode_nms_free,
    denormalize_bbox,
    normalize_bbox,
)

__all__ = [
    "HungarianAssigner3D",
    "bbox3d_l1_cost",
    "decode_nms_free",
    "normalize_bbox",
    "denormalize_bbox",
]
