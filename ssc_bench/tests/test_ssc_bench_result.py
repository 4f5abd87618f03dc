"""The result line has exactly its keys, the checks last."""

import json

from ssc_bench import harness
from ssc_bench.trace import Op, Trace


def outcome(trace=None):
    return harness.Outcome(
        correct=True, attempted=12, failed=0,
        metrics={"frames_per_s": 9.5, "setup_s": 30.25},
        checks={"logit_gap": {"value": 0.01, "limit": 0.05}},
        memory_peak_bytes=123, trace=trace, extra={"build_s": 0.0})


def test_untraced_line():
    line = json.loads(harness.result_line(
        outcome(), {"frames_per_s": "frames/s", "setup_s": "s"}, 1,
        "NVIDIA H100 80GB HBM3", False))
    keys = list(line)
    assert set(keys) - {"build_s", "checks"} == {
        "correct", "attempted", "failed", "metrics", "device"}
    assert keys[-1] == "checks"
    assert line["metrics"]["frames_per_s"] == {"value": 9.5,
                                               "unit": "frames/s"}
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}


def test_traced_line_has_breakdown_and_busy():
    t = Trace.__new__(Trace)
    t.ops = [Op("k", 0, 500, 0)]
    t.ranges = [("ssc.window", 0, 1000), ("ssc.infer", 0, 1000)]
    t.window = (0, 1000)
    line = json.loads(harness.result_line(
        outcome(t), {"frames_per_s": "frames/s", "setup_s": "s"}, 1, "x",
        True))
    assert set(line) - {"build_s", "checks"} == {
        "correct", "attempted", "failed", "metrics", "device", "breakdown"}
    assert list(line)[-1] == "checks"
    assert line["device"]["busy_s"] == 5e-7
    assert line["device"]["window_s"] == 1e-6
    assert line["breakdown"] == {"device_ops": [["k", 5e-7]],
                                 "idle_gaps": [["ssc.infer", 5e-7]]}
