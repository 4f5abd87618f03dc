"""The port's LiDAR depth products against the JAX package's numpy path.

The tree is tests/test_torch_data.py's, written as sequence 00 (the train
split) with a ``velodyne/*.bin`` scan and a ``labels/*.label`` lidarseg file
per frame. A scan holds points in front of the car, behind it and outside
the image, and rays with several returns, so that some pixels are hit by
more than one point. Each pipeline takes its g++ scatter when its native
library is available; ``native.available`` of both packages is patched to
False here, so both sides run numpy and every comparison is exact, except
in ``test_default_routes_match_jax``, which patches nothing: there both
take their default route (the native scatter where g++ builds, as it does
here), and the products must still be equal bitwise.
"""

import dataclasses
import os

import numpy as np
import pytest

import stereoscene_torch.native
import stereoscene_tpu.native
from stereoscene_tpu import data as jdata
from stereoscene_torch import data
from stereoscene_torch.data.labels import LEARNING_MAP
from stereoscene_torch.data.semantic_kitti import FrameInfo
from tests.test_torch_data import write_semkitti_tree

FRAMES = ("000000", "000001", "000002", "000003")
# the flagship config's data_config, and the same with augmentation on
CONFIG_AUG = dict(input_size=(384, 1280), resize=(0.0, 0.0), rot=(0.0, 0.0),
                  flip=False, crop_h=(0.0, 0.0))
JITTER_AUG = dict(input_size=(384, 1280), resize=(-0.06, 0.11),
                  rot=(-5.4, 5.4), flip=True, crop_h=(0.0, 0.1))


def lidar_scan(rng, n):
    """[n, 4] float32 velodyne points (x forward, y left, z up, reflectance)
    and their uint32 lidarseg labels (raw id in the low 16 bits, an instance
    id above). A fifth of the points are copies of others pushed 1.2-2x
    farther from the sensor: second returns near the same pixel."""
    base = n - n // 5
    pts = np.stack([rng.uniform(-15.0, 60.0, base),  # some behind the car
                    rng.uniform(-35.0, 35.0, base),  # some outside the image
                    rng.uniform(-2.5, 1.5, base),
                    rng.uniform(0.0, 1.0, base)], axis=1)
    far = pts[rng.randint(0, base, n - base)].copy()
    far[:, :3] *= rng.uniform(1.2, 2.0, (n - base, 1))
    pts = np.concatenate([pts, far]).astype(np.float32)
    raw = rng.choice(sorted(LEARNING_MAP), n).astype(np.uint32)
    labels = raw | (rng.randint(0, 40, n).astype(np.uint32) << 16)
    return pts, labels


def write_lidar(data_root, seq, frame_ids, n_points=20000, seed=0):
    """A scan and its labels per frame under
    ``data_root/dataset/sequences/<seq>/{velodyne,labels}``; returns the
    lidar root (also the lidarseg root)."""
    lidar_root = os.path.join(data_root, "dataset", "sequences")
    rng = np.random.RandomState(seed)
    for sub in ("velodyne", "labels"):
        os.makedirs(os.path.join(lidar_root, seq, sub), exist_ok=True)
    for fid in frame_ids:
        pts, labels = lidar_scan(rng, n_points)
        pts.tofile(os.path.join(lidar_root, seq, "velodyne", fid + ".bin"))
        labels.tofile(os.path.join(lidar_root, seq, "labels", fid + ".label"))
    return lidar_root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root, ann = write_semkitti_tree(str(tmp_path_factory.mktemp("lidar")),
                                    frame_ids=FRAMES, seq="00")
    lidar_root = write_lidar(root, "00", FRAMES)
    kw = dict(data_root=root, ann_file=ann, split="train",
              lidar_root=lidar_root, lidarseg_root=lidar_root)
    return (jdata.SemanticKittiIndex(**kw), data.SemanticKittiIndex(**kw))


@pytest.fixture(autouse=True)
def numpy_scatter(monkeypatch):
    monkeypatch.setattr(stereoscene_tpu.native, "available", lambda: False)
    monkeypatch.setattr(stereoscene_torch.native, "available",
                        lambda: False)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _pipelines(aug):
    cfg = dict(aug, is_train=True, load_lidar_depth=True)
    return (jdata.SemanticKittiPipeline(jdata.PipelineConfig(**cfg)),
            data.SemanticKittiPipeline(data.PipelineConfig(**cfg)))


def test_lidar_products_match_jax_bitwise(tree):
    jidx, tidx = tree
    jp, tp = _pipelines(JITTER_AUG)
    frame = tidx.frames[0]
    assert frame.lidar_path and frame.lidarseg_path
    sample = tp(frame, seed=5)
    keys = ("gt_depth", "img_seg", "points_occ", "points_uv", "points_count")
    got = tp._lidar_products(frame, sample)
    want = jp._lidar_products(jidx.frames[0], sample)
    assert set(got) == set(keys)
    _equal(want, got)
    h, w = JITTER_AUG["input_size"]
    assert got["gt_depth"].shape == got["img_seg"].shape == (2, h, w)
    assert got["points_occ"].shape == (65536, 4)
    assert got["points_uv"].shape == (65536, 3)
    n = int(got["points_count"])
    assert 0 < n < 20000  # some points fall behind or outside the image
    assert (got["points_occ"][n:] == 0).all()
    for eye in range(2):
        hit = got["gt_depth"][eye] > 0
        assert 0 < hit.sum() < n
        assert (got["img_seg"][eye][~hit] == 0).all()


def _frame(tmp_path, pts, labels):
    lidar = str(tmp_path / "scan.bin")
    seg = str(tmp_path / "scan.label")
    np.asarray(pts, np.float32).tofile(lidar)
    np.asarray(labels, np.uint32).tofile(seg)
    eye = np.eye(4)
    return FrameInfo(sequence="00", frame_id="000000", img_left_path="",
                     img_right_path="", P2=eye[:3], P3=eye[:3],
                     T_velo_2_cam=eye, voxel_path=None, calib=0.0,
                     lidar_path=lidar, lidarseg_path=seg)


@pytest.mark.parametrize("near_first", [True, False])
def test_the_nearest_point_wins_a_pixel(tmp_path, near_first):
    """Three points on one ray and one on another: each pixel keeps the
    depth and label of its nearest point, whatever the scan's order."""
    h, w = 8, 16
    f, cx, cy = 4.0, 7.0, 3.0
    pts = [[0.0, 0.0, 5.0, 0.0], [0.0, 0.0, 9.0, 0.0],
           [0.0, 0.0, 7.0, 0.0], [1.0, 1.0, 2.0, 0.0]]
    labels = [10, 40, 50, 30]  # train ids 1, 9, 13, 6
    order = [0, 1, 2, 3] if near_first else [1, 2, 0, 3]
    frame = _frame(tmp_path, [pts[i] for i in order],
                   [labels[i] for i in order])
    intrin = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]],
                      np.float32)
    sample = {"rots": np.stack([np.eye(3, dtype=np.float32)] * 2),
              "trans": np.zeros((2, 3), np.float32),
              "intrins": np.stack([intrin] * 2),
              "post_rots": np.stack([np.eye(3, dtype=np.float32)] * 2),
              "post_trans": np.zeros((2, 3), np.float32)}
    got = data.SemanticKittiPipeline(data.PipelineConfig(
        input_size=(h, w), load_lidar_depth=True))._lidar_products(
            frame, sample)
    want = jdata.SemanticKittiPipeline(jdata.PipelineConfig(
        input_size=(h, w), load_lidar_depth=True))._lidar_products(
            frame, sample)
    _equal(want, got)
    for eye in range(2):
        assert got["gt_depth"][eye, 3, 7] == 5.0
        assert got["img_seg"][eye, 3, 7] == 1
        assert got["gt_depth"][eye, 5, 9] == 2.0  # (1, 1, 2) -> u 9, v 5
        assert got["img_seg"][eye, 5, 9] == 6
        assert np.count_nonzero(got["gt_depth"][eye]) == 2
    assert int(got["points_count"]) == 4


def test_nearest_point_wins_on_a_scan(tree):
    """On a whole scan, every hit pixel holds the least depth of the
    in-image points that round to it, and some pixels have several."""
    _, tidx = tree
    _, tp = _pipelines(CONFIG_AUG)
    frame = tidx.frames[1]
    sample = tp(frame, seed=2)
    h, w = CONFIG_AUG["input_size"]
    pts = np.fromfile(frame.lidar_path, np.float32).reshape(-1, 4)[:, :3]
    uvd = data.pipeline.project_lidar_to_image(
        pts, sample["rots"][0], sample["trans"][0], sample["intrins"][0],
        sample["post_rots"][0], sample["post_trans"][0])
    keep = ((uvd[:, 0] >= 0) & (uvd[:, 1] >= 0) & (uvd[:, 0] <= w - 1)
            & (uvd[:, 1] <= h - 1) & (uvd[:, 2] > 0))
    uvd = uvd[keep]
    pix = (np.round(uvd[:, 1]).astype(np.int64) * w
           + np.round(uvd[:, 0]).astype(np.int64))
    least = np.full(h * w, np.inf, np.float32)
    np.minimum.at(least, pix, uvd[:, 2])
    least[np.isinf(least)] = 0
    np.testing.assert_array_equal(sample["gt_depth"][0].reshape(-1), least)
    assert (np.bincount(pix) > 1).sum() > 20


@pytest.mark.parametrize("aug", [CONFIG_AUG, JITTER_AUG],
                         ids=["config", "jitter"])
def test_train_pipeline_sample_matches_jax(tree, aug):
    jidx, tidx = tree
    jp, tp = _pipelines(aug)
    for i, seed in ((0, 3), (2, 11)):
        want = jp(jidx.frames[i], seed=seed)
        got = tp(tidx.frames[i], seed=seed)
        assert "gt_depth" in got and "gt_occ" in got
        _equal(want, got)


def test_batch_loader_epochs_match_jax(tree):
    jidx, tidx = tree
    jp, tp = _pipelines(JITTER_AUG)
    kw = dict(batch_size=2, shuffle=True, seed=7, num_workers=2)
    jl = jdata.BatchLoader(jidx.frames, jp, **kw)
    tl = data.BatchLoader(tidx.frames, tp, **kw)
    for _ in range(2):  # two epochs: new orders and augmentation draws
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == 2
        for a, b in zip(jb, tb):
            assert a["gt_depth"].shape == (2, 2, 384, 1280)
            _equal(a, b)
    assert dataclasses.asdict(tidx.frames[0]).keys() == \
        dataclasses.asdict(jidx.frames[0]).keys()


def test_default_routes_match_jax(tree, monkeypatch):
    """Neither package patched: the port's products equal the JAX
    pipeline's default ones bitwise, and the port names its route."""
    monkeypatch.undo()
    from tests.test_torch_native import load_jax_native

    load_jax_native()
    jidx, tidx = tree
    jp, tp = _pipelines(JITTER_AUG)
    assert data.pipeline.lidar_route() == (
        "native" if stereoscene_tpu.native.available() else "numpy")
    for i, seed in ((1, 4), (3, 9)):
        sample = tp(tidx.frames[i], seed=seed)
        _equal(jp._lidar_products(jidx.frames[i], sample),
               tp._lidar_products(tidx.frames[i], sample))
