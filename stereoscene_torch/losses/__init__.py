"""The loss zoo of the JAX package (ports of ``stereoscene_tpu/losses/``):
voxel CE, sem_scal, geo_scal, OHEM CE, the BCE and KL depth losses,
Lovasz-softmax, dice, the position-aware (LGA) CE, the frustum proportion
loss and the streaming evaluation of the CE / sem_scal / geo_scal triple."""

from .depth import bce_depth_loss, downsample_gt_depth
from .extras import (
    frustum_proportion_loss,
    gaussian_depth_target,
    klv_depth_loss,
    local_geometric_anisotropy,
    position_aware_loss,
    soft_dice_loss,
)
from .lovasz import lovasz_softmax
from .semkitti import (
    SEMANTIC_KITTI_CLASS_FREQUENCIES,
    ce_ssc_loss,
    class_weights_from_frequencies,
    geo_scal_loss,
    kl_sep,
    ohem_ce_ssc_loss,
    sem_scal_loss,
)

__all__ = [
    "SEMANTIC_KITTI_CLASS_FREQUENCIES",
    "bce_depth_loss",
    "ce_ssc_loss",
    "class_weights_from_frequencies",
    "downsample_gt_depth",
    "frustum_proportion_loss",
    "gaussian_depth_target",
    "geo_scal_loss",
    "kl_sep",
    "klv_depth_loss",
    "local_geometric_anisotropy",
    "lovasz_softmax",
    "ohem_ce_ssc_loss",
    "position_aware_loss",
    "sem_scal_loss",
    "soft_dice_loss",
]
