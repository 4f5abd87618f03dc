"""The port's nuScenes host side against the JAX package's: the index
(dict and list pickles, ``shard``) and ``NuScenesPipeline`` on a synthetic
mmdet3d info pickle of six 900x1600 cameras (as tests/test_nuscenes.py
writes it), in test mode and with every augmentation drawn; the nuScenes
detection scoring (``accumulate``, ``calc_ap``, ``calc_tp``,
``evaluate_detections`` with and without attributes,
``boxes_from_arrays``); and the KITTI -> Waymo box conversion.

These are numpy copies, so every output is held bitwise (to 1e-12 where
a float is compared).
"""

import pickle

import numpy as np
import pytest

from stereoscene_tpu.core import kitti2waymo as jk
from stereoscene_tpu.core import nuscenes_eval as je
from stereoscene_tpu.data import nuscenes as jn
from stereoscene_tpu.data.pipeline import PipelineConfig as JPipelineConfig
from stereoscene_torch.core import kitti2waymo as tk
from stereoscene_torch.core import nuscenes_eval as te
from stereoscene_torch.data import nuscenes as tn
from stereoscene_torch.data.pipeline import PipelineConfig


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    """Two samples of six seeded 900x1600 JPEGs, occupancy grids of
    200x200x16, both pickle layouts."""
    from PIL import Image

    root = tmp_path_factory.mktemp("nusc")
    (root / "samples").mkdir()
    (root / "occ").mkdir()
    rng = np.random.RandomState(0)
    infos = []
    for i in range(2):
        cams = {}
        for j, cam in enumerate(tn.NUSC_CAMERAS):
            path = root / "samples" / f"{cam}_{i}.jpg"
            Image.fromarray(rng.randint(0, 255, (900, 1600, 3),
                                        np.uint8)).save(path)
            yaw = np.deg2rad(60.0 * j)
            cams[cam] = {
                "data_path": str(path),
                "cam_intrinsic": np.array([[1266.4, 0, 816.3],
                                           [0, 1266.4, 491.5], [0, 0, 1]]),
                "sensor2lidar_rotation": np.array(
                    [[np.cos(yaw), -np.sin(yaw), 0],
                     [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]),
                "sensor2lidar_translation": rng.randn(3),
            }
        token = f"tok{i}"
        np.save(root / "occ" / f"{token}.npy",
                rng.randint(0, 17, (200, 200, 16)).astype(np.uint8))
        infos.append({"token": token, "cams": cams})
    with open(root / "infos.pkl", "wb") as f:
        pickle.dump({"infos": infos}, f)
    with open(root / "list.pkl", "wb") as f:
        pickle.dump(infos, f)
    return root


def test_index_matches_jax(nusc):
    for name in ("infos.pkl", "list.pkl"):
        ours = tn.NuScenesIndex(str(nusc / name), occ_root=str(nusc / "occ"))
        theirs = jn.NuScenesIndex(str(nusc / name))
        assert len(ours) == len(theirs) == 2
        assert ours.cameras == list(tn.NUSC_CAMERAS) == theirs.cameras
        assert ours[1]["token"] == theirs[1]["token"] == "tok1"
        assert [i["token"] for i in ours.shard(1, 2)] == ["tok1"]
        assert [i["token"] for i in ours.shard(0, 2)] == [
            i["token"] for i in theirs.shard(0, 2)]


AUGMENT = dict(resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True,
               crop_h=(0.0, 0.0), is_train=True)


@pytest.mark.parametrize("train", [False, True])
def test_pipeline_matches_jax(nusc, train):
    """Test mode, and training with resize, rotation and flip drawn from
    the seeded generator: images, calibration, homographies, bda and
    gt_occ bitwise equal, two samples in a row."""
    kw = dict(input_size=(256, 704), **(AUGMENT if train else {}))
    index = tn.NuScenesIndex(str(nusc / "infos.pkl"))
    ours = tn.NuScenesPipeline(PipelineConfig(**kw),
                               occ_root=str(nusc / "occ"), seed=3)
    theirs = jn.NuScenesPipeline(JPipelineConfig(**kw),
                                 occ_root=str(nusc / "occ"), seed=3)
    for i in range(len(index)):
        got, want = ours(index[i]), theirs(index[i])
        assert got.keys() == want.keys()
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert got["imgs"].shape == (6, 256, 704, 3)
    assert got["gt_occ"].shape == (200, 200, 16)
    if not train:
        np.testing.assert_allclose(got["post_rots"][0][0, 0], 704 / 1600,
                                   rtol=1e-6)


def _box(mod, rng, tok, name, score=-1.0, attr="", near=None):
    xyz = (rng.uniform(-40, 40, 3) if near is None
           else near + rng.randn(3) * 0.8)
    return mod.DetBox(sample_token=tok, translation=xyz,
                      size=rng.uniform(0.5, 5, 3),
                      yaw=float(rng.uniform(-np.pi, np.pi)),
                      velocity=rng.randn(2), detection_name=name,
                      score=score, attribute_name=attr)


def _scene(mod, seed, attributes):
    """GT boxes over 3 samples and 4 classes (barrier's period is pi), and
    predictions: noisy copies of most GT boxes, and false positives; a
    third of the GT attributes empty (the NaN-skipped accuracy)."""
    rng = np.random.RandomState(seed)
    classes = ("car", "pedestrian", "barrier", "bus")
    attrs = ("moving", "parked", "")
    gts, preds = [], []
    for s in range(3):
        tok = f"s{s}"
        for _ in range(12):
            name = classes[rng.randint(4)]
            attr = attrs[rng.randint(3)] if attributes else ""
            g = _box(mod, rng, tok, name, attr=attr)
            gts.append(g)
            if rng.rand() < 0.8:
                guess = attrs[rng.randint(2)] if attributes else ""
                preds.append(_box(mod, rng, tok, name, float(rng.rand()),
                                  guess, near=g.translation))
        for _ in range(5):
            preds.append(_box(mod, rng, tok, classes[rng.randint(4)],
                              float(rng.rand())))
    return gts, preds, classes


@pytest.mark.parametrize("attributes", [False, True])
def test_scoring_matches_jax(attributes):
    ours = _scene(te, 1, attributes)
    theirs = _scene(je, 1, attributes)
    gts, preds, classes = ours
    for th in je.DIST_THRESHOLDS:
        a = te.accumulate(gts, preds, "barrier", th)
        b = je.accumulate(theirs[0], theirs[1], "barrier", th)
        for field in ("recall", "precision", "confidence", "trans_err",
                      "scale_err", "orient_err", "vel_err", "attr_err"):
            np.testing.assert_allclose(getattr(a, field), getattr(b, field),
                                       rtol=0, atol=1e-12, err_msg=field)
        assert te.calc_ap(a) == je.calc_ap(b)
        assert te.calc_tp(a, "orient_err") == je.calc_tp(b, "orient_err")
    got = te.evaluate_detections(gts, preds, classes,
                                 with_attributes=attributes)
    want = je.evaluate_detections(theirs[0], theirs[1], classes,
                                  with_attributes=attributes)
    assert ("attr_err" in got.tp_errors) == attributes
    assert 0 < got.mean_ap < 1 and 0 < got.nd_score < 1
    np.testing.assert_allclose(
        [got.mean_ap, got.nd_score, *got.class_aps.values(),
         *got.tp_errors.values()],
        [want.mean_ap, want.nd_score, *want.class_aps.values(),
         *want.tp_errors.values()], rtol=0, atol=1e-12)
    assert got.class_tps == want.class_tps


def test_box_helpers_match_jax():
    rng = np.random.RandomState(2)
    a, b = _box(te, rng, "s", "car"), _box(te, rng, "s", "car")
    ja = je.DetBox(**a.__dict__)
    jb_ = je.DetBox(**b.__dict__)
    for fn in ("center_distance", "scale_iou", "velocity_l2"):
        assert getattr(te, fn)(a, b) == getattr(je, fn)(ja, jb_)
    assert te.yaw_diff(a, b, np.pi) == je.yaw_diff(ja, jb_, np.pi)
    boxes = rng.randn(4, 9)
    labels = np.array([0, 3, 9, 5])
    kw = dict(scores=rng.rand(4), attributes=["x", "", "y", "z"])
    got = te.boxes_from_arrays(["t"] * 4, boxes, labels, **kw)
    want = je.boxes_from_arrays(["t"] * 4, boxes, labels, **kw)
    for g, w in zip(got, want):
        assert g.detection_name == w.detection_name
        assert g.score == w.score and g.attribute_name == w.attribute_name
        for field in ("translation", "size", "velocity"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
    short = te.boxes_from_arrays(["t"], boxes[:1, :7], labels[:1])
    assert short[0].score == -1.0 and not short[0].velocity.any()


def test_kitti_to_waymo_matches_jax():
    """Every KITTI class, headings that wrap past both ends of [-pi, pi],
    one frame's objects; the proto writer needs waymo_open_dataset in both
    packages."""
    rng = np.random.RandomState(3)
    t_k2w = rng.randn(4, 4) @ tk.T_REF_TO_FRONT_CAM
    result = {"name": np.array(["Car", "Pedestrian", "Sign", "Cyclist"]),
              "dimensions": rng.uniform(0.5, 5, (4, 3)),
              "location": rng.uniform(-30, 30, (4, 3)),
              "rotation_y": np.array([-3.1, -0.2, 1.7, 3.1]),
              "score": rng.rand(4)}
    got = tk.kitti_result_to_waymo_objects(result, t_k2w, "ctx", 1234)
    want = jk.kitti_result_to_waymo_objects(result, t_k2w, "ctx", 1234)
    assert got == want
    assert [o["type"] for o in got] == [1, 2, 3, 4]
    assert all(-np.pi <= o["heading"] <= np.pi for o in got)
    one = tk.kitti_box_to_waymo("Car", [4.0, 1.5, 1.8], [1.0, 1.6, 20.0],
                                0.0, 0.91234, tk.T_REF_TO_FRONT_CAM)
    assert one == jk.kitti_box_to_waymo("Car", [4.0, 1.5, 1.8],
                                        [1.0, 1.6, 20.0], 0.0, 0.91234,
                                        jk.T_REF_TO_FRONT_CAM)
    assert one["center_x"] == 20.0 and one["center_z"] == -(1.6 - 0.75)
    assert one["heading"] == -np.pi / 2 and one["score"] == 0.9123
    assert tk._HAVE_WAYMO == jk._HAVE_WAYMO
    if not tk._HAVE_WAYMO:
        with pytest.raises(ImportError, match="waymo_open_dataset"):
            tk.KITTI2Waymo([], "in", "out", "final.bin", "p")
