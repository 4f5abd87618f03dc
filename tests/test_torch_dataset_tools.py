"""The port's dataset CLIs (``stereoscene_torch.tools.{print_config,
debug_dataset, browse_dataset, create_data, flops_table}``) against the
JAX package's (``tools/misc/print_config.py``, ``tools/debug_dataset.py``,
``tools/misc/browse_dataset.py``, ``tools/create_data.py``), each run as
a script (``runpy``) on the same synthetic tree or pickle.

- ``print_config``: the same JSON for each of the port's configs and its
  JAX counterpart.
- ``debug_dataset``: the same lines on a tree with LiDAR, both pipelines
  on their default routes, and the port's one more line naming the route.
- ``browse_dataset``: the same PNG arrays.
- ``create_data``: the same ``semantickitti`` label ``.npy`` files (two
  scales) and the same ``nuscenes`` sample count.
- ``flops_table`` at TINY: its stages sum to the eval CLI's ``--flops``
  count of one eval forward.
"""

import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from stereoscene_torch.engine import flops as flops_mod
from stereoscene_torch.tools import (browse_dataset, create_data,
                                     debug_dataset, flops_table,
                                     print_config)
from stereoscene_torch.tools import test as test_cli
from tests.test_torch_data import write_semkitti_tree
from tests.test_torch_lidar import write_lidar
from tests.test_torch_native import load_jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("stereoscene_semantickitti", "stereoscene_tiny",
           "stereoscene_highres", "bevocc_kitti")
PORT_TINY = os.path.join(ROOT, "stereoscene_torch", "configs",
                         "stereoscene_tiny.py")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_jax(script, args, monkeypatch, capsys):
    """Run ``ROOT/script`` as ``__main__`` with ``args``; its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [script] + list(args))
    runpy.run_path(os.path.join(ROOT, script), run_name="__main__")
    return capsys.readouterr().out


def run_port(main, args, capsys):
    capsys.readouterr()
    main(list(args))
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A train tree with LiDAR and a config that reads it (the tiny
    config's model)."""
    tmp = tmp_path_factory.mktemp("tools")
    frames = ("000000", "000001")
    root, ann = write_semkitti_tree(str(tmp), frame_ids=frames, seq="00")
    lidar = write_lidar(root, "00", frames, n_points=15000, seed=2)
    cfg = tmp / "tree.py"
    cfg.write_text(
        f"_base_ = [{PORT_TINY!r}]\n"
        f"data = dict(train=dict(data_root={root!r}, ann_file={ann!r}))\n"
        f"lidar_root = {lidar!r}\nlidarseg_root = {lidar!r}\n")
    load_jax_native()
    return str(cfg), tmp


@pytest.mark.parametrize("name", CONFIGS)
def test_print_config_matches_jax(name, monkeypatch, capsys):
    port = os.path.join(ROOT, "stereoscene_torch", "configs", f"{name}.py")
    jax_cfg = os.path.join(ROOT, "stereoscene_tpu", "configs", f"{name}.py")
    got = run_port(print_config.main, [port], capsys)
    want = run_jax("tools/misc/print_config.py", [jax_cfg], monkeypatch,
                   capsys)
    assert got == want and got.startswith("{")


def test_debug_dataset_matches_jax(tree, monkeypatch, capsys):
    cfg, tmp = tree
    args = [cfg, "--num-frames", "2"]
    got = run_port(debug_dataset.main,
                   args + ["--out", str(tmp / "port_dbg")], capsys)
    want = run_jax("tools/debug_dataset.py",
                   args + ["--out", str(tmp / "jax_dbg")], monkeypatch,
                   capsys)
    got_lines = got.splitlines()
    assert got_lines[0] == "LiDAR depth route: native"
    strip = [line.replace("port_dbg", "jax_dbg") for line in got_lines[1:]]
    assert strip == want.splitlines()
    assert any("gt_depth" in line for line in strip)
    for png in sorted(os.listdir(tmp / "jax_dbg")):
        from PIL import Image

        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp / "port_dbg" / png)),
            np.asarray(Image.open(tmp / "jax_dbg" / png)))


def test_browse_dataset_matches_jax(tree, monkeypatch, capsys):
    from PIL import Image

    cfg, tmp = tree
    args = [cfg, "--num-frames", "1"]
    run_port(browse_dataset.main, args + ["--out", str(tmp / "pb")], capsys)
    run_jax("tools/misc/browse_dataset.py", args + ["--out", str(tmp / "jb")],
            monkeypatch, capsys)
    got = np.asarray(Image.open(tmp / "pb" / "frame0000.png"))
    want = np.asarray(Image.open(tmp / "jb" / "frame0000.png"))
    assert got.shape == want.shape and got.shape[:2] == (800, 1400)
    np.testing.assert_array_equal(got, want)


def test_create_data_semantickitti_matches_jax(tmp_path, monkeypatch,
                                               capsys):
    rng = np.random.RandomState(5)
    vox = tmp_path / "kitti" / "dataset" / "sequences" / "00" / "voxels"
    vox.mkdir(parents=True)
    n = 256 * 256 * 32
    rng.choice([0, 10, 40, 252, 99, 70], n).astype(np.uint16).tofile(
        vox / "000000.label")
    np.packbits((rng.rand(n) < 0.1).astype(np.uint8)).tofile(
        vox / "000000.invalid")
    args = ["semantickitti", "--root", str(tmp_path / "kitti"),
            "--scales", "1_1", "1_2"]
    got = run_port(create_data.main, args + ["--out", str(tmp_path / "p")],
                   capsys)
    want = run_jax("tools/create_data.py",
                   args + ["--out", str(tmp_path / "j")], monkeypatch, capsys)
    assert got == want == "wrote 2 label files\n"
    for name in ("000000_1_1.npy", "000000_1_2.npy"):
        a = np.load(tmp_path / "p" / "labels" / "00" / name)
        np.testing.assert_array_equal(
            a, np.load(tmp_path / "j" / "labels" / "00" / name))
    assert a.shape == (128, 128, 16)


def test_create_data_nuscenes_counts_as_jax(tmp_path, monkeypatch, capsys):
    infos = [{"token": f"s{i}", "scene_token": "scene-0", "cams": {}}
             for i in range(7)]
    with open(tmp_path / "nuscenes_infos_train.pkl", "wb") as f:
        pickle.dump({"infos": infos}, f)
    args = ["nuscenes", "--root", str(tmp_path), "--out", str(tmp_path)]
    got = run_port(create_data.main, args, capsys)
    want = run_jax("tools/create_data.py", args, monkeypatch, capsys)
    assert got == want and "validated 7 samples" in got
    with pytest.raises(SystemExit, match="missing"):
        create_data.main(["nuscenes", "--root", str(tmp_path / "none"),
                          "--out", str(tmp_path)])


def test_flops_table_sums_to_the_eval_cli_count(tmp_path, monkeypatch,
                                                capsys):
    root, ann = write_semkitti_tree(str(tmp_path), frame_ids=("000000",))
    counted = []
    report = flops_mod.report

    def capture(*args, **kwargs):
        counted.append(report(*args, **kwargs))
        return counted[-1]

    monkeypatch.setattr(flops_mod, "report", capture)
    test_cli.main([PORT_TINY, "--device", "cpu", "--flops", "--cfg-options",
                   f"data.val.data_root={root}", f"data.val.ann_file={ann}"])
    table = flops_table.main([PORT_TINY, "--device", "cpu"])
    stages = [table[name] for name in flops_table.STAGES]
    assert all(f > 0 for f in stages)
    assert sum(stages) == table["TOTAL"] == counted[0]["flops"]
    out = capsys.readouterr().out
    assert "TOTAL forward" in out and "bev encoder + head" in out
