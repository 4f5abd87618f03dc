"""The port's measurement tools, ``stereoscene_torch.tools.bench_train``
and ``stereoscene_torch.tools.highres_slice``, against the JAX tools
(``tools/bench_train.py``, ``tools/highres_slice.py``) and the port's own
train step, on the CPU at TINY:

- the highres slice cuts the grid as the JAX tool does (``dataclasses.
  replace`` on the JAX ``DetectorConfig.from_config``), for 2, 4 and 8
  shards, and refuses a shard count that does not divide X;
- the frames carry the flagship calibration of ``bench.py``'s
  ``make_flagship_batch`` and the JAX train bench's targets, and the
  slice's frame is ``__graft_entry__._make_batch``'s, bitwise;
- each tool's timed loss is bitwise that of as many ``make_train_step``
  calls on the same seeded state and batch: the tool adds nothing to the
  step;
- ``fwd_gflop`` and the slice's forward ``analyzed_tflops`` equal
  ``flops_table.stage_flops``' sum for the same model and batch;
- each tool prints exactly its JSON keys (``mfu`` null on the CPU), runs
  on the card unless ``--device cpu`` and names no TPU constant.
"""

import ast
import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from stereoscene_tpu.config import Config as JConfig
from stereoscene_tpu.models.detector import DetectorConfig as JDetectorConfig
from stereoscene_torch.config import Config
from stereoscene_torch.engine.loop import step_generator
from stereoscene_torch.engine.train import (LossConfig, create_train_state,
                                            make_train_step)
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.tools import _frames, bench_train, flops_table
from stereoscene_torch.tools import highres_slice
from stereoscene_torch.utils.weights import seeded_init_

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_CONFIGS = ROOT / "stereoscene_torch" / "configs"
TINY_PATH = str(PORT_CONFIGS / "stereoscene_tiny.py")
TINY = DetectorConfig.from_config(Config.fromfile(TINY_PATH))
# TINY with 8 Z planes for the bf16 steps: oneDNN's bf16 Conv3d on the CPU
# (torch 2.13.0+cpu) reads uninitialised memory where a stride-2 conv meets
# an input depth of 1 or 2, which TINY's 4 planes give at ResNet3D's last
# stage, so its bf16 steps differ from run to run (NaN where that memory
# held NaN); at 8 planes every step is repeatable
TINY_Z8 = dataclasses.replace(TINY, zbound=(-2.0, 6.0, 1.0))
Z8_OVERRIDE = ("model = dict(img_view_transformer=dict(grid_config=dict("
               "zbound=[-2.0, 6.0, 1.0])))\n")
BENCH_KEYS = {"metric", "batch", "step_ms", "steps_per_sec",
              "frames_per_sec", "mfu", "loss", "with_cp", "bev_cp", "accum",
              "fwd_gflop", "device", "peak_gib"}
SLICE_KEYS = {"mode", "shards", "grid", "step_ms", "value", "hbm_peak_gb",
              "hbm_in_use_gb", "hbm_limit_gb", "analyzed_tflops"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_highres():
    path = ROOT / "stereoscene_tpu" / "configs" / "stereoscene_highres.py"
    return JDetectorConfig.from_config(JConfig.fromfile(str(path)))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_slice_cut_equals_the_jax_tools(shards):
    full = DetectorConfig.from_config(
        Config.fromfile(str(PORT_CONFIGS / "stereoscene_highres.py")))
    ours = highres_slice.slice_config(full, shards)
    # tools/highres_slice.py:58-70
    jfull = jax_highres()
    x, y, z = jfull.grid_shape
    step_x = jfull.xbound[2]
    theirs = dataclasses.replace(
        jfull, xbound=(jfull.xbound[0],
                       jfull.xbound[0] + step_x * (x // shards), step_x))
    assert ours.grid_shape == theirs.grid_shape == (x // shards, y, z)
    assert ours.xbound == theirs.xbound
    assert (ours.ybound, ours.zbound) == (theirs.ybound, theirs.zbound)
    assert full.grid_shape == (256, 256, 32)


@pytest.mark.parametrize("cfg,shards", [("highres", 3), ("highres", 6),
                                        ("tiny", 3)])
def test_slice_refuses_a_shard_count_that_does_not_divide_x(cfg, shards):
    full = (TINY if cfg == "tiny" else DetectorConfig.from_config(
        Config.fromfile(str(PORT_CONFIGS / "stereoscene_highres.py"))))
    with pytest.raises(ValueError, match="does not divide the grid's X"):
        highres_slice.slice_config(full, shards)


@pytest.mark.parametrize("train", [False, True])
def test_slice_checkpoints_only_in_training(train):
    cut = highres_slice.slice_config(TINY, 2, train=train)
    assert cut.backbone_with_cp is cut.bev_with_cp is train
    assert not highres_slice.slice_config(TINY, 2, True,
                                          bev_cp=False).bev_with_cp


@pytest.mark.parametrize("y,chunks", [(256, 16), (256, 12), (16, 5),
                                      (16, 0)])
def test_stream_chunks_fall_to_a_divisor_as_in_jax(y, chunks):
    cfg = dataclasses.replace(TINY, ybound=(0.0, float(y), 1.0))
    # tools/highres_slice.py:123-126
    want = chunks
    if chunks > 0 and y % chunks:
        want = max(d for d in range(1, chunks + 1) if y % d == 0)
    assert highres_slice.stream_chunks(cfg, chunks) == want


@pytest.mark.parametrize("b", [1, 2])
def test_frames_carry_the_jax_calibration_and_targets(b):
    from bench import make_flagship_batch

    jcfg = JDetectorConfig()
    theirs = make_flagship_batch(jcfg, b)
    ours = _frames.train_frame(DetectorConfig(), "cpu", seed=0, b=b)
    for key in ("rots", "trans", "intrins", "post_rots", "post_trans",
                "bda", "calib"):
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(theirs[key]), key)
    assert ours["imgs"].shape == tuple(theirs["imgs"].shape)
    # tools/bench_train.py:63-71
    rng = np.random.RandomState(1)
    x, y, z = jcfg.grid_shape
    h, w = jcfg.input_size
    np.testing.assert_array_equal(
        ours["gt_occ"].numpy(), rng.randint(0, 20, (b, 2 * x, 2 * y, 2 * z)))
    np.testing.assert_array_equal(
        ours["gt_depth"].numpy(),
        (rng.rand(b, 2, h, w) < 0.05).astype(np.float32) * 20.0)
    one = _frames.frame(DetectorConfig(), "cpu", seed=3)
    assert torch.equal(one["imgs"], torch.randn(
        1, 2, 384, 1280, 3, generator=torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("b", [1, 2])
def test_slice_frame_is_the_jax_tools(b):
    from __graft_entry__ import _make_batch

    jfull = jax_highres()
    x = jfull.grid_shape[0]
    jcut = dataclasses.replace(jfull, xbound=(
        jfull.xbound[0], jfull.xbound[0] + jfull.xbound[2] * (x // 4),
        jfull.xbound[2]))
    theirs = _make_batch(jcut, b)
    full = DetectorConfig.from_config(
        Config.fromfile(str(PORT_CONFIGS / "stereoscene_highres.py")))
    ours = _frames.slice_frame(highres_slice.slice_config(full, 4), "cpu", b)
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(want),
                                      key)
    assert ours["gt_occ"].shape == (b, 128, 512, 64)


def plain_losses(cfg, batch, steps, loss_cfg, accum=1, steps_per_epoch=100):
    """``loss_total`` of ``steps`` make_train_step calls on the seeded
    model, step i drawing from ``step_generator(0, i)``."""
    torch.manual_seed(123)  # the tools must not depend on the global RNG
    model = BEVDepthOccupancy(cfg, device="cpu")
    seeded_init_(model, 0)
    state = create_train_state(model, steps_per_epoch=steps_per_epoch,
                               accumulate_steps=accum, device="cpu")
    step = make_train_step(loss_cfg, bf16=True)
    losses = []
    for i in range(steps):
        state, logs = step(state, batch, step_generator(0, i, "cpu"))
        losses.append(float(logs["loss_total"]))
    return losses


@pytest.mark.parametrize("b,accum", [(1, 1), (2, 2)])
def test_bench_train_loss_is_the_train_steps(b, accum):
    cfg = dataclasses.replace(TINY_Z8, backbone_with_cp=True)
    record = bench_train.run(cfg, b, iters=1, accum=accum, device="cpu")
    batch = _frames.train_frame(cfg, "cpu", 0, b)
    want = plain_losses(cfg, batch, 1 + bench_train.WARMUP + 1,
                        LossConfig(downsample=cfg.downsample,
                                   dbound=cfg.dbound), accum)
    assert record["loss"] == want[-1]
    assert record["batch"] == b and record["accum"] == accum


def test_highres_slice_train_loss_is_the_train_steps():
    record = highres_slice.run(TINY_Z8, shards=2, train=True, iters=1,
                               chunks=3, device="cpu")
    cfg = highres_slice.slice_config(TINY_Z8, 2, train=True)
    batch = _frames.slice_frame(cfg, "cpu")
    want = plain_losses(cfg, batch, 1 + highres_slice.WARMUP + 1,
                        LossConfig(downsample=cfg.downsample,
                                   dbound=cfg.dbound, stream_voxel_chunks=2),
                        steps_per_epoch=10)
    assert record["value"] == want[-1]
    assert record["grid"] == [8, 16, 8] and record["mode"] == "train"


@pytest.mark.parametrize("b", [1, 2])
def test_fwd_gflop_equals_the_flops_table(b):
    record = bench_train.run(TINY, b, iters=1, device="cpu")
    model = BEVDepthOccupancy(TINY, device="cpu")
    stages = flops_table.stage_flops(model, _frames.train_frame(
        TINY, "cpu", 0, b))
    assert record["fwd_gflop"] == sum(stages.values()) / b / 1e9
    assert record["fwd_gflop"] > 0


def test_slice_forward_flops_equal_the_flops_table():
    record = highres_slice.run(TINY, shards=2, iters=1, device="cpu")
    cfg = highres_slice.slice_config(TINY, 2)
    model = BEVDepthOccupancy(cfg, device="cpu")
    stages = flops_table.stage_flops(model, _frames.slice_frame(cfg, "cpu"))
    assert record["analyzed_tflops"] == sum(stages.values()) / 1e12 > 0


def tiny_detector(**kw):
    return dataclasses.replace(TINY_Z8, **kw)


def z8_config(tmp_path):
    path = tmp_path / "tiny_z8.py"
    path.write_text(f"_base_ = [{TINY_PATH!r}]\n" + Z8_OVERRIDE)
    return str(path)


def last_json(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return [json.loads(ln) for ln in lines]


def test_bench_train_prints_its_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench_train, "DetectorConfig", tiny_detector)
    records = bench_train.main(["--batches", "1,2", "--iters", "1",
                                "--no-with-cp", "--bev-cp", "--device",
                                "cpu"])
    printed = last_json(capsys.readouterr().out)
    assert printed == records and len(records) == 2
    for record, b in zip(records, (1, 2)):
        assert set(record) == BENCH_KEYS
        assert record["metric"] == "train_step" and record["batch"] == b
        assert record["mfu"] is None and record["peak_gib"] is None
        assert record["device"] == "cpu"
        assert record["with_cp"] is False and record["bev_cp"] is True
        assert np.isfinite(record["loss"]) and record["step_ms"] > 0
        assert record["frames_per_sec"] == pytest.approx(
            b * record["steps_per_sec"])


@pytest.mark.parametrize("train", [False, True])
def test_highres_slice_prints_its_keys(train, monkeypatch, capsys,
                                      tmp_path):
    monkeypatch.setattr(highres_slice, "HIGHRES", z8_config(tmp_path))
    argv = ["--shards", "4", "--iters", "1", "--device", "cpu"]
    record = highres_slice.main(argv + ["--train"] * train)
    assert last_json(capsys.readouterr().out) == [record]
    assert set(record) == SLICE_KEYS
    assert record["mode"] == ("train" if train else "forward")
    assert record["shards"] == 4 and record["grid"] == [4, 16, 8]
    assert record["hbm_peak_gb"] is None and record["hbm_limit_gb"] is None
    assert np.isfinite(record["value"]) and record["step_ms"] > 0
    assert record["analyzed_tflops"] > 0


@pytest.mark.parametrize("tool", ["bench_train", "highres_slice"])
def test_tools_run_on_the_card_unless_told(tool, monkeypatch):
    monkeypatch.setattr(bench_train, "DetectorConfig", tiny_detector)
    monkeypatch.setattr(highres_slice, "HIGHRES", TINY_PATH)
    module = {"bench_train": bench_train, "highres_slice": highres_slice}
    assert module[tool].parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises((RuntimeError, AssertionError)):
        module[tool].main(["--iters", "1"] + (
            ["--batches", "1"] if tool == "bench_train" else ["--shards",
                                                              "2"]))


def test_mfu_peak_is_the_cards_own():
    assert bench_train.PEAK_BF16 == {"NVIDIA H100 80GB HBM3": 989.4e12}
    assert bench_train.peak_flops(torch.device("cpu")) is None


def test_port_names_no_tpu_constant():
    """The JAX train bench's v5e peak (197 TFLOP/s) and its analytic
    forward (3.93 TFLOP a frame) appear in no file of the port."""
    bad = []
    for path in sorted((ROOT / "stereoscene_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        bad += [(path.name, node.lineno) for node in ast.walk(tree)
                if isinstance(node, ast.Constant)
                and type(node.value) in (int, float)
                and node.value in (197, 3.93, 197e12, 3.93e12)]
    assert not bad, f"TPU constants at {bad}"
