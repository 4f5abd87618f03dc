"""The port's high-resolution config (stereoscene_torch/configs/
stereoscene_highres.py) parsed as the JAX package parses its own:
``DetectorConfig.from_config`` field by field, the grid of 256x256x32
voxels, the 512x512x64 label grid, D = 112, and the train CLI's
``LossConfig`` (``tools.train.loss_config``) against the one the JAX CLI
builds (tools/train.py) from the JAX config, with ``stream_voxel_chunks``
16. The flagship and TINY configs are held the same way."""

import dataclasses
import os

import pytest

from stereoscene_tpu.config import Config as JConfig
from stereoscene_tpu.engine.train import LossConfig as JLossConfig
from stereoscene_tpu.models.detector import DetectorConfig as JDetectorConfig
from stereoscene_torch.config import Config
from stereoscene_torch.models.detector import DetectorConfig
from stereoscene_torch.tools.train import loss_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _paths(name):
    return (os.path.join(ROOT, "stereoscene_torch", "configs", name),
            os.path.join(ROOT, "stereoscene_tpu", "configs", name))


def _jax_loss_config(cfg, det_cfg):
    """The JAX CLI's LossConfig (tools/train.py)."""
    loss_w = cfg["model"]["pts_bbox_head"]["semkitti_loss_weight_cfg"]
    return JLossConfig(
        voxel_ce=loss_w.get("voxel_ce", 1.0),
        voxel_sem_scal=loss_w.get("voxel_sem_scal", 1.0),
        voxel_geo_scal=loss_w.get("voxel_geo_scal", 1.0),
        voxel_ohem=loss_w.get("voxel_ohem", 0.0),
        voxel_lovasz=loss_w.get("voxel_lovasz", 0.0),
        stream_voxel_chunks=loss_w.get("stream_voxel_chunks", 0),
        loss_depth_weight=cfg["model"]["img_view_transformer"].get(
            "loss_depth_weight", 1.0),
        downsample=det_cfg.downsample,
        dbound=det_cfg.dbound,
    )


@pytest.mark.parametrize("name", ["stereoscene_highres.py",
                                  "stereoscene_semantickitti.py",
                                  "stereoscene_tiny.py"])
def test_config_parses_as_jax(name):
    ours_path, theirs_path = _paths(name)
    ours, theirs = Config.fromfile(ours_path), JConfig.fromfile(theirs_path)
    assert ours["occ_size"] == theirs["occ_size"]
    det, jdet = DetectorConfig.from_config(ours), \
        JDetectorConfig.from_config(theirs)
    jfields = dataclasses.asdict(jdet)
    shared = [f for f in dataclasses.asdict(det) if f in jfields]
    assert len(shared) > 30
    for field in shared:
        assert getattr(det, field) == jfields[field], field
    assert det.grid_shape == jdet.grid_shape
    assert det.num_depth == jdet.num_depth
    assert dataclasses.asdict(loss_config(ours, det)) == dataclasses.asdict(
        _jax_loss_config(theirs, jdet))
    assert ours["tpu"] == theirs["tpu"]


def test_highres_shapes():
    cfg = Config.fromfile(_paths("stereoscene_highres.py")[0])
    det = DetectorConfig.from_config(cfg)
    assert det.grid_shape == (256, 256, 32)
    assert tuple(cfg["occ_size"]) == (512, 512, 64)
    assert det.num_depth == 112
    assert loss_config(cfg, det).stream_voxel_chunks == 16
    # 256 divides into 2, 4 or 8 slabs at the 3D encoder's total stride 4
    assert all(det.grid_shape[0] % (s * 4) == 0 for s in (2, 4, 8))
