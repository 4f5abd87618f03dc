"""SemanticKITTI data layer (port of ``stereoscene_tpu/data/``): label maps,
the dataset index, the per-frame pipeline and the batch loader."""

from .labels import LEARNING_MAP, LEARNING_MAP_INV, inv_map, remap_lut
from .loader import BatchLoader
from .pipeline import PipelineConfig, SemanticKittiPipeline
from .semantic_kitti import SemanticKittiIndex, dynamic_baseline, read_calib

__all__ = [
    "BatchLoader",
    "LEARNING_MAP",
    "LEARNING_MAP_INV",
    "PipelineConfig",
    "SemanticKittiIndex",
    "SemanticKittiPipeline",
    "dynamic_baseline",
    "inv_map",
    "read_calib",
    "remap_lut",
]
