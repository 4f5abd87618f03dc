"""The port's training-data branches against the JAX package's: the grid
mask, the BEV augmentation (BDA) matrix and label transform, the MonoScene
label downsample and the CRP relation matrix, the pipeline with BDA and
relation labels, CBGS resampling and the label preprocessor.

Everything but the grid mask is numpy on both sides and compared bitwise.
The grid mask draws from ``jax.random`` in the JAX package and from a
``torch.Generator`` in the port, so the masks are held equal for equal
draws (apply, d, sx, sy), and the port's draws are held to their
distribution.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu import data as jdata
from stereoscene_tpu.data import augment as jaug
from stereoscene_tpu.data import labels as jlabels
from stereoscene_tpu.data import preprocess as jpre
from stereoscene_torch import data
from stereoscene_torch.data import augment
from stereoscene_torch.data import labels
from stereoscene_torch.data import preprocess
from stereoscene_torch.tools import preprocess_kitti
from tests.test_torch_data import write_semkitti_tree

TRAIN_IDS = ("000000", "000001", "000002", "000003", "000004")


def _jax_draws(key, b, d_range=(96, 224), prob=0.7):
    """The four draws of the JAX package's ``grid_mask``, as it makes them
    (data/augment.py:38-42)."""
    k_apply, k_d, k_sx, k_sy = jax.random.split(key, 4)
    return (jax.random.bernoulli(k_apply, prob, (b,)),
            jax.random.randint(k_d, (b,), d_range[0], d_range[1]),
            jax.random.randint(k_sx, (b,), 0, d_range[1]),
            jax.random.randint(k_sy, (b,), 0, d_range[1]))


@pytest.mark.parametrize("mode,ratio,seed", [(1, 0.5, 0), (0, 0.5, 1),
                                             (1, 0.3, 2)])
def test_grid_mask_equals_jax_for_equal_draws(mode, ratio, seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(6, 96, 200, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.grid_mask(jnp.asarray(imgs), key, ratio=ratio,
                                     mode=mode))
    draws = [torch.from_numpy(np.array(d)).to(
        torch.bool if i == 0 else torch.int64)
        for i, d in enumerate(_jax_draws(key, 6))]
    assert 0 < int(draws[0].sum()) < 6  # both branches of ``apply``
    mask = augment.grid_mask_from_draws(96, 200, *draws, ratio=ratio,
                                        mode=mode)
    got = torch.from_numpy(imgs).permute(0, 3, 1, 2) * mask[:, None]
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_grid_mask_draws_follow_their_distribution():
    n, prob = 20000, 0.7
    gen = torch.Generator().manual_seed(0)
    apply, d, sx, sy = augment.grid_mask_draws(n, gen, "cpu", prob=prob)
    assert abs(float(apply.float().mean()) - prob) < 4 * (
        prob * (1 - prob) / n) ** 0.5
    assert int(d.min()) == 96 and int(d.max()) == 223
    for off in (sx, sy):
        assert int(off.min()) == 0 and int(off.max()) == 223
        assert abs(float(off.float().mean()) - 111.5) < 4 * 64.7 / n ** 0.5
    # mode 1 keeps the rows and columns whose offset position falls in
    # the first ceil(d / 2) of each period
    imgs = torch.ones(8, 3, 96, 200)
    out = augment.grid_mask(imgs, torch.Generator().manual_seed(1), prob=1.0)
    _, d, sx, sy = augment.grid_mask_draws(
        8, torch.Generator().manual_seed(1), "cpu", prob=1.0)
    k = torch.ceil(d / 2.0)[:, None]
    rows = ((torch.arange(96)[None] + sy[:, None]) % d[:, None] < k)
    cols = ((torch.arange(200)[None] + sx[:, None]) % d[:, None] < k)
    want = rows[:, :, None] & cols[:, None, :]
    assert torch.equal(out, want[:, None].float().expand_as(out))


@pytest.mark.parametrize("rot,fx,fy", [(0.0, False, False), (13.7, True,
                                                             False),
                                       (-22.1, False, True), (5.0, True,
                                                              True)])
def test_bev_transform_matrix_and_labels_equal_jax(rot, fx, fy):
    center = np.array([25.6, 0.0, 1.2], np.float32)
    np.testing.assert_array_equal(
        augment.bev_transform_matrix(rot, fx, fy, center),
        jaug.bev_transform_matrix(rot, fx, fy, center))
    occ = np.random.RandomState(3).choice(
        [0, 1, 9, 15, 255], (32, 32, 8)).astype(np.uint8)
    got = augment.bev_transform_labels(occ, rot, fx, fy)
    np.testing.assert_array_equal(got,
                                  jaug.bev_transform_labels(occ, rot, fx, fy))
    if rot:
        assert (got == 255).mean() > (occ == 255).mean()


@pytest.mark.parametrize("ds", [1, 2, (2, 2, 1), (4, 4, 2)])
def test_downsample_label_monoscene_equals_jax(ds):
    rng = np.random.RandomState(4)
    occ = rng.choice([0, 3, 9, 11, 255], (16, 16, 8),
                     p=[0.5, 0.1, 0.1, 0.1, 0.2]).astype(np.uint8)
    occ[:4, :4] = 0  # empty blocks
    occ[4:8, :4] = 255  # invalid blocks
    got = labels.downsample_label_monoscene(occ, ds)
    want = jlabels.downsample_label_monoscene(occ, ds)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("binary", [False, True])
def test_cp_mega_matrix_equals_jax(binary):
    occ = np.random.RandomState(5).choice(
        [0, 2, 9, 255], (8, 8, 4)).astype(np.uint8)
    got = labels.compute_cp_mega_matrix(occ, binary)
    want = jlabels.compute_cp_mega_matrix(occ, binary)
    assert got.shape == ((2 if binary else 4), 256, 32)
    assert got.dtype == want.dtype and got.any()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """Five train frames whose labels mix the classes in different
    proportions, so CBGS resamples them unevenly."""
    root, ann = write_semkitti_tree(str(tmp_path_factory.mktemp("semkitti")),
                                    frame_ids=TRAIN_IDS, seq="00")
    rng = np.random.RandomState(9)
    for i, fid in enumerate(TRAIN_IDS):
        p = np.array([0.5, 0.02 + 0.1 * i, 0.3 - 0.05 * i, 0.05, 0.03 * i,
                      0.1])
        occ = rng.choice([0, 1, 9, 11, 15, 255], size=(32, 32, 8),
                         p=p / p.sum())
        np.save(os.path.join(ann, "00", f"{fid}_1_1.npy"),
                occ.astype(np.uint8))
    return root, ann


def _equal_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("bda,relation", [(True, False), (False, True),
                                          (True, True)])
def test_pipeline_bda_and_relation_labels_equal_jax(train_tree, bda,
                                                    relation):
    root, ann = train_tree
    kw = dict(input_size=(64, 128), resize=(-0.06, 0.11), rot=(-5.4, 5.4),
              flip=True, is_train=True, apply_bda=bda,
              bda_rot_lim=(-22.5, 22.5),
              point_cloud_range=(0, -8.0, -2, 16.0, 8.0, 2.0),
              relation_label_shape=(8, 8, 4) if relation else None)
    jp = jdata.SemanticKittiPipeline(jdata.PipelineConfig(**kw))
    tp = data.SemanticKittiPipeline(data.PipelineConfig(**kw))
    jidx = jdata.SemanticKittiIndex(root, ann, "train")
    tidx = data.SemanticKittiIndex(root, ann, "train")
    for jf, tf in zip(jidx.frames[:2], tidx.frames[:2]):
        for seed in (3, 11):
            got = tp(tf, seed=seed)
            _equal_samples(jp(jf, seed=seed), got)
            raw = np.load(tf.voxel_path)
            assert got["gt_occ"].shape == raw.shape
            assert got["bda"].shape == ((4, 4) if bda else (3, 3))
            if bda:
                assert not np.allclose(got["bda"], np.eye(4))
                assert (got["gt_occ"] == 255).mean() > (raw == 255).mean()
            if relation:
                assert got["cp_mega_matrix"].shape == (4, 256, 32)


@pytest.mark.parametrize("repeat", [1, 3])
def test_cbgs_frame_list_equals_jax(train_tree, repeat):
    root, ann = train_tree
    kw = dict(data_root=root, ann_file=ann, split="train", cbgs=True,
              repeat=repeat, seed=5)
    want = jdata.SemanticKittiIndex(**kw)
    got = data.SemanticKittiIndex(**kw)
    plain = data.SemanticKittiIndex(root, ann, "train")
    assert len(got) == len(want) > 0
    assert ([f.frame_id for f in got.frames]
            != [f.frame_id for f in plain.frames])
    assert ([f.frame_id for f in got.frames]
            == [f.frame_id for f in want.frames])


def _write_raw_voxels(root, seq, fids, seed):
    """Packed ``.label`` (uint16 raw ids) and ``.invalid`` (bit-packed)
    files of the raw SemanticKITTI layout."""
    rng = np.random.RandomState(seed)
    vox = os.path.join(root, "dataset", "sequences", seq, "voxels")
    os.makedirs(vox, exist_ok=True)
    n = int(np.prod(jpre.SCENE_SIZE))
    raw = np.array(sorted(jlabels.LEARNING_MAP), np.uint16)
    for fid in fids:
        lab = np.where(rng.rand(n) < 0.6, 0, rng.choice(raw, n))
        lab.astype(np.uint16).tofile(os.path.join(vox, fid + ".label"))
        np.packbits(rng.rand(n) < 0.1).tofile(
            os.path.join(vox, fid + ".invalid"))


def test_preprocess_equals_jax(tmp_path):
    root = str(tmp_path / "kitti")
    _write_raw_voxels(root, "00", ("000000", "000001"), 6)
    _write_raw_voxels(root, "01", ("000000",), 7)
    vox = os.path.join(root, "dataset", "sequences", "00", "voxels")
    frame = [os.path.join(vox, "000000" + ext)
             for ext in (".label", ".invalid")]
    grid = preprocess.process_frame(*frame)
    np.testing.assert_array_equal(grid, jpre.process_frame(*frame))
    assert set(np.unique(grid)) > {0, 255}
    np.testing.assert_array_equal(preprocess.majority_downsample(grid, 2),
                                  jpre.majority_downsample(grid, 2))
    rng = np.random.RandomState(8)
    pts = rng.uniform(-1, 17, (5000, 3)).astype(np.float32)
    lab = rng.randint(0, 20, 5000)
    pc = (0, 0, 0, 16, 16, 16)
    np.testing.assert_array_equal(
        preprocess.create_voxel_labels(pts, lab, (8, 8, 8), pc),
        jpre.create_voxel_labels(pts, lab, (8, 8, 8), pc))

    outs = {}
    for name, run in (
            ("jax", lambda out: jpre.process_sequences(
                root, out, ["00", "01"], ("1_1", "1_2"), verbose=False)),
            ("port", lambda out: preprocess_kitti.main([
                "--kitti-root", root, "--out-root", out, "--sequences",
                "00", "01", "--scales", "1_1", "1_2"]))):
        out = str(tmp_path / name)
        run(out)
        outs[name] = {os.path.relpath(os.path.join(d, f), out):
                      np.load(os.path.join(d, f))
                      for d, _, files in os.walk(out) for f in files}
    assert len(outs["port"]) == 6
    _equal_samples(outs["jax"], outs["port"])
