"""The active loss recipe: voxel CE, sem_scal, geo_scal and the BCE depth
loss (ports of ``stereoscene_tpu/losses/``)."""

from .depth import bce_depth_loss, downsample_gt_depth
from .semkitti import (
    SEMANTIC_KITTI_CLASS_FREQUENCIES,
    ce_ssc_loss,
    class_weights_from_frequencies,
    geo_scal_loss,
    sem_scal_loss,
)

__all__ = [
    "SEMANTIC_KITTI_CLASS_FREQUENCIES",
    "bce_depth_loss",
    "ce_ssc_loss",
    "class_weights_from_frequencies",
    "downsample_gt_depth",
    "geo_scal_loss",
    "sem_scal_loss",
]
