"""Tests of the benchmark harness, on the CPU at test widths. Tests that
need a CUDA card are marked ``cuda`` and skip inside the test where there
is none."""

import json
import os

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def tiny_cell():
    """A cell of the given traffic on the test-width configuration
    (``tiny.json``) with float32 limits for its float32 runs
    (``tiny_limits.json``), the traffic shortened to a few frames or
    batches."""
    from ssc_bench.cell import Cell, load

    torch.set_num_threads(2)

    def make(workload, **traffic):
        base = load(ROOT, workload)
        with open(os.path.join(HERE, "tiny.json")) as f:
            config = json.load(f)
        with open(os.path.join(HERE, "tiny_limits.json")) as f:
            limits = json.load(f)[base.traffic["kind"]]
        base.traffic.update(traffic)
        return Cell(workload, 1, config, base.traffic, base.end_to_end,
                    base.per_layer, limits)

    return make


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
