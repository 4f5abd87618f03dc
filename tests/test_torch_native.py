"""The port's native host library (``stereoscene_torch.native``, its own
copy of ``kitti_host.cc``) against the JAX package's, and the LiDAR
products of the two pipelines on their default routes.

- The four C entries, bitwise against the JAX library's on seeded inputs
  that hold half-pixel points (u = 2.5) and points of equal depth.
- The numpy routes of both packages, bitwise, and where the two routes of
  one package differ (the native scatter rounds u + 0.5 down and keeps the
  first of two equal depths, numpy rounds half to even and keeps the last).
- Two processes that build the library into one empty directory at once
  both load it (the build writes a name of its own and renames it), and
  so do four threads of one process (a lock holds them to one build).
- The pipelines with nothing patched: bitwise ``gt_depth`` / ``img_seg`` /
  ``points_*``, and the route the port names.

Every test needs g++ (the JAX package's own native tests skip without it);
the machines the suite runs on have it.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import stereoscene_tpu.native as jnative
from stereoscene_tpu import data as jdata
from stereoscene_tpu.data import preprocess as jpre
from stereoscene_torch import data, native
from stereoscene_torch.data import preprocess
from stereoscene_torch.data.labels import remap_lut
from tests.test_torch_data import write_semkitti_tree
from tests.test_torch_lidar import JITTER_AUG, write_lidar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_native():
    """Load the JAX package's library, waiting out a build by another test
    worker: it builds in place, so a worker can meet a half-written file
    and mark the library unavailable for the rest of its process."""
    for _ in range(60):
        if jnative.load() is not None:
            return
        jnative._load_failed = False
        time.sleep(0.5)
    raise RuntimeError("the JAX package's native library does not load")


@pytest.fixture(scope="module", autouse=True)
def libraries():
    load_jax_native()
    assert native.available(), "the port's native library did not build"


def _scatter_points(rng, n=4000, h=24, w=40):
    """[n, 3] (u, v, d) in the image with half-pixel u and v, repeated
    pixels and points of equal depth on one pixel, and their labels."""
    u = rng.uniform(0, w - 1, n).astype(np.float32)
    v = rng.uniform(0, h - 1, n).astype(np.float32)
    d = rng.uniform(1.0, 50.0, n).astype(np.float32)
    half_u, half_v = rng.rand(n) < 0.2, rng.rand(n) < 0.2
    u[half_u] = np.floor(u[half_u]) + 0.5
    v[half_v] = np.minimum(np.floor(v[half_v]) + 0.5, h - 1)
    # a tenth of the points copy another's pixel and depth
    src, dst = rng.randint(3, n, n // 10), rng.randint(3, n, n // 10)
    u[dst], v[dst], d[dst] = u[src], v[src], d[src]
    u[:3] = [2.5, 2.5, 7.0]
    v[:3] = [1.0, 1.0, 3.5]
    d[:3] = [4.0, 4.0, 9.0]
    seg = rng.randint(1, 20, n).astype(np.float32)
    seg[:2] = [2.0, 3.0]
    return np.stack([u, v, d], 1), seg, h, w


def test_scatter_depth_matches_jax_bitwise():
    uvd, seg, h, w = _scatter_points(np.random.RandomState(0))
    got = native.scatter_depth(uvd, h, w, seg)
    want = jnative.scatter_depth(uvd, h, w, seg)
    for g, t in zip(got, want):
        np.testing.assert_array_equal(g, t)
    np.testing.assert_array_equal(native.scatter_depth(uvd, h, w),
                                  jnative.scatter_depth(uvd, h, w))
    # u = 2.5 lands in column 3, and the first of two equal depths keeps
    # its label (2)
    assert got[0][1, 3] == 4.0 and got[1][1, 3] == 2.0


def test_the_two_scatter_routes_differ_where_stated():
    uvd, seg, h, w = _scatter_points(np.random.RandomState(0))
    dn, sn = native.scatter_depth(uvd, h, w, seg)
    dp, sp = data.pipeline.scatter_depth_numpy(uvd, seg, h, w)
    # numpy: u = 2.5 rounds to 2 (half to even), the last tie wins (3)
    assert dp[1, 2] == 4.0 and sp[1, 2] == 3.0 and dn[1, 2] != 4.0
    # v = 3.5 rounds to 4 both ways
    assert dn[4, 7] == dp[4, 7] == 9.0
    exact = (np.abs(uvd[:, :2] - np.floor(uvd[:, :2]) - 0.5) > 1e-3).all(1)
    hit = np.zeros((h, w), bool)
    hit[np.round(uvd[~exact, 1]).astype(int),
        np.round(uvd[~exact, 0]).astype(int)] = True
    hit[np.floor(uvd[~exact, 1] + 0.5).astype(int),
        np.floor(uvd[~exact, 0] + 0.5).astype(int)] = True
    # pixels that no half-pixel point reaches agree in depth
    np.testing.assert_array_equal(dn[~hit & (dn > 0) & (dp > 0)],
                                  dp[~hit & (dn > 0) & (dp > 0)])


def test_unpack_and_majority_entries_match_jax_bitwise():
    rng = np.random.RandomState(1)
    n = 8 * 2048
    raw = rng.choice([0, 10, 40, 252, 99, 70], n).astype(np.uint16)
    packed = np.packbits((rng.rand(n) < 0.2).astype(np.uint8))
    lut = remap_lut()
    np.testing.assert_array_equal(
        native.unpack_remap_labels(raw, packed, lut),
        jnative.unpack_remap_labels(raw, packed, lut))
    grid = rng.choice([0, 1, 9, 255], (16, 16, 8),
                      p=[0.6, 0.15, 0.15, 0.1]).astype(np.uint8)
    for k in (2, 4):
        np.testing.assert_array_equal(native.majority_downsample(grid, k),
                                      jnative.majority_downsample(grid, k))
        np.testing.assert_array_equal(native.majority_downsample(grid, k),
                                      preprocess.majority_downsample(grid, k))


def test_point_majority_vote_matches_jax_bitwise():
    rng = np.random.RandomState(2)
    coords = rng.randint(0, 6, (3000, 3)).astype(np.int32)
    labels = rng.randint(0, 20, 3000).astype(np.int32)
    np.testing.assert_array_equal(
        native.point_majority_vote(coords, labels, (6, 6, 6), 20),
        jnative.point_majority_vote(coords, labels, (6, 6, 6), 20))


def _label_files(tmp_path, rng):
    n = 256 * 256 * 32
    raw = rng.choice([0, 10, 40, 252, 99, 70], n).astype(np.uint16)
    lp, ip = str(tmp_path / "f.label"), str(tmp_path / "f.invalid")
    raw.tofile(lp)
    np.packbits((rng.rand(n) < 0.1).astype(np.uint8)).tofile(ip)
    return lp, ip


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_preprocess_matches_jax_on_each_route(tmp_path, monkeypatch, route):
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.RandomState(3)
    lp, ip = _label_files(tmp_path, rng)
    got = preprocess.process_frame(lp, ip)
    np.testing.assert_array_equal(got, jpre.process_frame(lp, ip))
    assert got.shape == (256, 256, 32) and got.dtype == np.uint8
    pts = rng.uniform([0, -25.6, -2], [51.2, 25.6, 4.4],
                      (5000, 3)).astype(np.float32)
    labels = rng.randint(0, 20, 5000)
    pc = (0, -25.6, -2, 51.2, 25.6, 4.4)
    np.testing.assert_array_equal(
        preprocess.create_voxel_labels(pts, labels, (32, 32, 4), pc),
        jpre.create_voxel_labels(pts, labels, (32, 32, 4), pc))


_BUILD = """
import sys
from pathlib import Path
import stereoscene_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
assert n.available(), "not loaded"
print(n.library_path().name)
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {o.strip().splitlines()[-1] for o in outs}
    assert names == {native.library_path().name}
    left = sorted(os.listdir(tmp_path))
    assert left == sorted(names), left  # no temporary file left behind


_THREADS = """
import sys
import threading
from pathlib import Path
import stereoscene_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
start = threading.Barrier(4)
got = []

def call():
    start.wait()
    got.append(n.available())

threads = [threading.Thread(target=call) for _ in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert got == [True] * 4, got
print(n.library_path().name)
"""


def test_four_threads_building_at_once_all_load(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _THREADS, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == native.library_path().name
    assert os.listdir(tmp_path) == [native.library_path().name]


def test_pipelines_on_their_default_routes_match_bitwise(tmp_path):
    frames = ("000000", "000001")
    root, ann = write_semkitti_tree(str(tmp_path), frame_ids=frames,
                                    seq="00")
    lidar = write_lidar(root, "00", frames, n_points=30000, seed=4)
    kw = dict(data_root=root, ann_file=ann, split="train", lidar_root=lidar,
              lidarseg_root=lidar)
    cfg = dict(JITTER_AUG, is_train=True, load_lidar_depth=True)
    jp = jdata.SemanticKittiPipeline(jdata.PipelineConfig(**cfg))
    tp = data.SemanticKittiPipeline(data.PipelineConfig(**cfg))
    jidx, tidx = (jdata.SemanticKittiIndex(**kw),
                  data.SemanticKittiIndex(**kw))
    assert data.pipeline.lidar_route() == "native"
    for i, seed in ((0, 1), (1, 6)):
        want, got = jp(jidx.frames[i], seed=seed), tp(tidx.frames[i],
                                                      seed=seed)
        assert want.keys() == got.keys()
        for k in ("gt_depth", "img_seg", "points_occ", "points_uv",
                  "points_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
