"""The control of ``correct``: the plain reference put in the program's
place and computed in float8 (e4m3, per-tensor scales), the precision
below the configuration's bfloat16, has to fail the cell's limits. At
test widths on the CPU here; at the cell's own size on the card in the
``cuda`` case (``calibrate.py --control`` gives the same readings)."""

import json
import os

import pytest

from ssc_bench import calibrate, check
from ssc_bench.cell import Cell, load

from .conftest import HERE, ROOT


def limits(workload):
    return load(ROOT, workload).limits


def tiny(workload, **traffic):
    base = load(ROOT, workload)
    base.traffic.update(traffic)
    with open(os.path.join(HERE, "tiny.json")) as f:
        return Cell(workload, 1, json.load(f), base.traffic, [], [], {})


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serving_control_fails(seed):
    readings = calibrate._serve_control(
        tiny("kitti-serve-stream", pool=4, check_frames=2), seed, "cpu")
    assert not check.passed(check.judge(readings,
                                        limits("kitti-serve-stream")))


@pytest.mark.parametrize("workload", ["kitti-train-b2", "highres-train-b1"])
@pytest.mark.parametrize("seed", [1, 2])
def test_training_control_fails(workload, seed):
    readings = calibrate._train_control(tiny(workload, batches=3), seed,
                                        "cpu")
    assert not check.passed(check.judge(readings, limits(workload)))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti-serve-stream",
                                      "highres-serve-stream",
                                      "kitti-train-b2", "highres-train-b1"])
def test_control_fails_at_the_cells_size(cuda_card, workload):
    cell = load(ROOT, workload)
    run = (calibrate._serve_control if cell.traffic["kind"] == "serve"
           else calibrate._train_control)
    for seed in (101, 202, 303):
        assert not check.passed(check.judge(run(cell, seed, cuda_card),
                                            cell.limits))
