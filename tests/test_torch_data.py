"""The port's data layer and config loader against the JAX package's, over
a synthetic SemanticKITTI tree written here.

The tree: sequence 08 (the val split) with 376x1241 stereo PNGs, the
calibration of tests/test_data.py, ``voxels/*.bin`` frame markers and voxel
labels written directly as ``{ann}/08/{fid}_1_1.npy``. Every comparison is
exact: both sides are the same numpy and PIL code.
"""

import dataclasses
import os

import numpy as np
import pytest

from stereoscene_tpu import config as jconfig
from stereoscene_tpu import data as jdata
from stereoscene_tpu.data import labels as jlabels
from stereoscene_tpu.engine.loop import pad_batch as jax_pad_batch
from stereoscene_tpu.models.detector import DetectorConfig as JaxConfig
from stereoscene_torch import config
from stereoscene_torch import data
from stereoscene_torch.data import labels
from stereoscene_torch.engine.loop import pad_batch
from stereoscene_torch.models.detector import DetectorConfig
from tests.test_data import CALIB_TXT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["stereoscene_semantickitti.py", "stereoscene_tiny.py"]
LABEL_SHAPE = (32, 32, 8)  # occ_size of stereoscene_tiny.py


def write_semkitti_tree(root, frame_ids=("000000", "000005"),
                        label_shape=LABEL_SHAPE, seed=0, seq="08"):
    """Sequence ``seq`` (08: the val split; 00: train) under ``root``:
    returns (data_root, ann_file)."""
    from PIL import Image

    seq_dir = os.path.join(root, "dataset", "sequences", seq)
    ann = os.path.join(root, "labels")
    for sub in ("image_2", "image_3", "voxels"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    os.makedirs(os.path.join(ann, seq), exist_ok=True)
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write(CALIB_TXT)
    rng = np.random.RandomState(seed)
    for fid in frame_ids:
        for cam in ("image_2", "image_3"):
            arr = rng.randint(0, 255, (376, 1241, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(seq_dir, cam, fid + ".png"))
        with open(os.path.join(seq_dir, "voxels", fid + ".bin"), "wb") as f:
            f.write(b"\0")
        occ = rng.choice([0, 1, 9, 11, 15, 255], size=label_shape,
                         p=[0.6, 0.08, 0.1, 0.07, 0.05, 0.1])
        np.save(os.path.join(ann, seq, f"{fid}_1_1.npy"), occ.astype(np.uint8))
    return root, ann


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_semkitti_tree(str(tmp_path_factory.mktemp("semkitti")))


def _indices(tree, split="val"):
    root, ann = tree
    return (jdata.SemanticKittiIndex(data_root=root, ann_file=ann,
                                     split=split),
            data.SemanticKittiIndex(data_root=root, ann_file=ann,
                                    split=split))


def _equal_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_label_luts_match_jax():
    assert labels.LEARNING_MAP == jlabels.LEARNING_MAP
    assert labels.LEARNING_MAP_INV == jlabels.LEARNING_MAP_INV
    for name in ("remap_lut", "seg_remap_lut", "inv_map"):
        a, b = getattr(jlabels, name)(), getattr(labels, name)()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


def test_read_calib_and_index_match_jax(tree):
    root, _ = tree
    path = os.path.join(root, "dataset", "sequences", "08", "calib.txt")
    jc, tc = jdata.read_calib(path), data.read_calib(path)
    assert jc.keys() == tc.keys()
    for k in jc:
        np.testing.assert_array_equal(jc[k], tc[k])
    assert data.dynamic_baseline(tc) == jdata.dynamic_baseline(jc)
    jidx, tidx = _indices(tree)
    assert len(tidx) == len(jidx) == 2
    for jf, tf in zip(jidx.frames, tidx.frames):
        ja, ta = dataclasses.asdict(jf), dataclasses.asdict(tf)
        assert ja.keys() == ta.keys()
        for k in ja:
            np.testing.assert_array_equal(np.asarray(ja[k]), np.asarray(ta[k]))
    assert len(_indices(tree, "train")[1]) == 0
    assert tidx.shard(1, 2) == tidx.frames[1::2]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_aug"])
def test_pipeline_samples_match_jax(tree, train):
    jidx, tidx = _indices(tree)
    aug = dict(resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True,
               crop_h=(0.0, 0.1), is_train=True) if train else {}
    jp = jdata.SemanticKittiPipeline(
        jdata.PipelineConfig(input_size=(64, 128), **aug))
    tp = data.SemanticKittiPipeline(
        data.PipelineConfig(input_size=(64, 128), **aug))
    for i, (jf, tf) in enumerate(zip(jidx.frames, tidx.frames)):
        for seed in ((3, 11) if train else (None,)):
            _equal_samples(jp(jf, seed=seed), tp(tf, seed=seed))
    sample = tp(tidx.frames[0])
    assert sample["imgs"].shape == (2, 64, 128, 3)
    assert sample["gt_occ"].shape == LABEL_SHAPE


def test_pipeline_refuses_the_training_data_branches():
    """BEV augmentation and the CRP relation labels are not ported; the
    LiDAR depth branch is (tests/test_torch_lidar.py)."""
    for kwargs in (dict(apply_bda=True, is_train=True),
                   dict(relation_label_shape=(32, 32, 4))):
        with pytest.raises(NotImplementedError):
            data.SemanticKittiPipeline(data.PipelineConfig(**kwargs))
    data.SemanticKittiPipeline(data.PipelineConfig(load_lidar_depth=True))


@pytest.mark.parametrize("batch_size,shuffle", [(1, True), (2, False)])
def test_batch_loader_and_pad_batch_match_jax(tree, batch_size, shuffle):
    jidx, tidx = _indices(tree)
    cfg = dict(input_size=(64, 128), resize=(-0.06, 0.11), rot=(-5.4, 5.4),
               flip=True, is_train=True)
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=7, num_workers=2,
              drop_last=False)
    jl = jdata.BatchLoader(
        jidx.frames, jdata.SemanticKittiPipeline(jdata.PipelineConfig(**cfg)),
        **kw)
    tl = data.BatchLoader(
        tidx.frames, data.SemanticKittiPipeline(data.PipelineConfig(**cfg)),
        **kw)
    assert len(tl) == len(jl)
    for _ in range(2):  # two epochs: new orders and augmentation draws
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl)
        for a, b in zip(jb, tb):
            _equal_samples(a, b)
            _equal_samples(jax_pad_batch(a, 3), pad_batch(b, 3))
    padded = pad_batch(tb[-1], 3)
    assert (padded["gt_occ"][batch_size:] == 255).all()


def test_loader_raises_a_worker_error(tree):
    def broken(frame):
        raise RuntimeError("decode failed")

    _, tidx = _indices(tree)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(data.BatchLoader(tidx.frames, broken, batch_size=1))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_and_detector_config_match_jax(name):
    jcfg = jconfig.Config.fromfile(
        os.path.join(ROOT, "stereoscene_tpu", "configs", name))
    tcfg = config.Config.fromfile(
        os.path.join(ROOT, "stereoscene_torch", "configs", name))
    assert dict(tcfg) == dict(jcfg)
    opts = ["data.val.data_root=/data/x", "model.img_backbone.with_cp=false",
            "occ_size=1,2,3"]
    assert (config.merge_from_options(tcfg, list(opts))
            == jconfig.merge_from_options(jcfg, list(opts)))
    assert tcfg["occ_size"] == (1, 2, 3) and tcfg.data.val.data_root == "/data/x"
    assert dataclasses.asdict(DetectorConfig.from_config(tcfg)) == \
        dataclasses.asdict(JaxConfig.from_config(jcfg))
