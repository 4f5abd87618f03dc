"""The harness finds each cell's configuration, traffic and metric readers
by name, and BENCHMARK.json keeps to the shapes the benchmark takes."""

import json
import os
import re

import pytest

from ssc_bench import cell as cells

from .conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = cells.load(ROOT, workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["kind"] in ("serve", "train")
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for metric in cell.per_layer:
        assert callable(cell.reader(metric["name"]))


def test_unknown_workload_refused():
    with pytest.raises(KeyError):
        cells.load(ROOT, "no-such-cell")


def test_names_units_and_moves():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"] and config["reduced"] == []


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_limits_name_numbers_the_comparison_reads(workload):
    from ssc_bench import check

    cell = cells.load(ROOT, workload)
    numbers = (cell.family.SERVE_NUMBERS if cell.traffic["kind"] == "serve"
               else check.train_numbers(cell.family))
    assert cell.limits and set(cell.limits) <= set(numbers)
    assert all(0 < v < 1 for v in cell.limits.values())
