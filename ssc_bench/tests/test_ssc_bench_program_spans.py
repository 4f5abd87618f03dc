"""The readers of the program's spans on hand-made traces: idle by span
for sibling and nested ranges, operations by their launch time (one
launched on another thread inside the backward), the division by frames
and steps, None without a trace or spans, and a reader file for every
per-layer metric of ``BENCHMARK.json``."""

import json
import os

import pytest

from ssc_bench import program_spans
from ssc_bench.cell import HERE as BENCH_DIR
from ssc_bench.cell import Cell

from .conftest import ROOT
from .test_ssc_bench_arith import fake_trace

CELL = Cell("x", 1, {}, {}, [], [], {})


def read(metric, ctx):
    return CELL.reader(metric)(ctx)


def serve_trace():
    """Two frames of 1,000 ns, each: plan [0, 100) with its build [20, 60),
    images [100, 400), view [400, 700) with its splat [600, 700), bev
    [700, 900), classmap [900, 950), all inside infer [0, 1000) inside the
    harness's ssc.infer. The device runs [0, 10), [100, 200), [300, 650),
    [750, 850) of each frame."""
    ops, ranges = [], []
    for f in (0, 1000):
        ops += [("copy", f, f + 10, f + 5),
                ("conv", f + 100, f + 200, f + 90),
                ("gemm", f + 300, f + 650, f + 250),
                ("splat", f + 750, f + 850, f + 610),
                ("norm", f + 750, f + 800, f + 720)]
        ranges += [("ssc.infer", f, f + 1000),
                   ("stereoscene.infer", f, f + 1000),
                   ("stereoscene.plan", f, f + 100),
                   ("stereoscene.plan.build", f + 20, f + 60),
                   ("stereoscene.images", f + 100, f + 400),
                   ("stereoscene.view", f + 400, f + 700),
                   ("stereoscene.view.splat", f + 600, f + 700),
                   ("stereoscene.bev", f + 700, f + 900),
                   ("stereoscene.classmap", f + 900, f + 950)]
    return fake_trace(ops, ranges, window=(0, 2000))


@pytest.mark.parametrize("metric,want", [
    # gaps of a frame: [10, 100) mid 55 plan; [200, 300) mid 250 images;
    # [650, 750) mid 700 bev (view ends where bev starts, at the midpoint);
    # [850, 1000) mid 925 classmap
    ("plan_idle_ms.serve", 90e-6),
    ("images_idle_ms.serve", 100e-6),
    ("view_idle_ms.serve", 0.0),
    ("bev_idle_ms.serve", 250e-6),
    ("launches.serve", 5.0)])
def test_serving_readers_per_frame(metric, want):
    ctx = {"trace": serve_trace(), "frames": 2}
    assert read(metric, ctx) == pytest.approx(want)


def test_idle_of_sibling_and_nested_ranges():
    t = serve_trace()
    # the gap [10, 100) has its midpoint in the nested build as in the plan
    assert program_spans.idle_ns(t, ["stereoscene.plan.build"]) == 180
    assert program_spans.idle_ns(t, ["stereoscene.plan"]) == 180
    assert program_spans.idle_ns(
        t, ["stereoscene.plan", "stereoscene.plan.build"]) == 180
    assert program_spans.idle_ns(
        t, ["stereoscene.view", "stereoscene.view.splat"]) == 0
    # the siblings together hold every idle ns of infer and of the
    # harness's ssc.infer here, each once
    stages = ["stereoscene.plan", "stereoscene.images", "stereoscene.view",
              "stereoscene.bev", "stereoscene.classmap"]
    assert program_spans.idle_ns(t, stages) == 880
    assert program_spans.idle_ns(t, ["stereoscene.infer"]) == 880
    assert dict(t.idle_gaps())["ssc.infer"] == pytest.approx(880e-9)


def test_intervals_merge_nested_and_overlapping_ranges():
    t = fake_trace([], [("a", 0, 100), ("a", 10, 20), ("a", 90, 150),
                        ("a", 200, 210), ("b", 0, 500)])
    assert program_spans.intervals(t, ["a"]) == [(0, 150), (200, 210)]


def train_trace():
    """Two steps of 1,000 ns: forward [0, 400), backward [400, 800),
    optimizer [800, 950). The backward's kernels are launched by
    autograd's device thread at times inside the backward range; one
    operation has no linked launch."""
    ops, ranges = [], []
    for s in (0, 1000):
        ops += [("fwd", s + 50, s + 250, s + 10),
                ("fwd_late", s + 380, s + 420, s + 390),
                ("bwd_thread", s + 450, s + 700, s + 430),
                ("adam", s + 820, s + 900, s + 810),
                ("unlinked", s + 960, s + 970, None)]
        ranges += [("ssc.step", s, s + 1000),
                   ("stereoscene.forward", s, s + 400),
                   ("stereoscene.images", s + 10, s + 200),
                   ("stereoscene.backward", s + 400, s + 800),
                   ("stereoscene.images", s + 420, s + 600),  # recompute
                   ("stereoscene.optimizer", s + 800, s + 950),
                   ("Optimizer.step#AdamW.step", s + 805, s + 940)]
    return fake_trace(ops, ranges, window=(0, 2000))


@pytest.mark.parametrize("metric,want", [
    # launched in the forward: fwd 200 + fwd_late 40 (launched at 390,
    # running into the backward's time)
    ("forward_ms.train", 240e-6),
    ("backward_ms.train", 250e-6),
    # gaps: [0, 50) mid 25 forward; [250, 380) mid 315 forward; [420,
    # 450) mid 435 backward; [700, 820) mid 760 backward; [900, 960) mid
    # 930 optimizer; [970, 1050) mid 1010 the second step's forward (which
    # has no gap before its first operation); [1970, 2000) no phase
    ("forward_idle_ms.train", (50 + 130 + 80 + 130) / 2 * 1e-6),
    ("backward_idle_ms.train", (30 + 120) * 1e-6),
    ("launches.train", 4.0)])
def test_training_readers_per_step(metric, want):
    ctx = {"trace": train_trace(), "steps": 2, "frames": 4}
    assert read(metric, ctx) == pytest.approx(want)


def test_phases_stay_within_the_busy_time():
    """forward + backward + the AdamW range's device time is at most the
    device's busy time."""
    t = train_trace()
    ctx = {"trace": t, "steps": 2}
    phases = read("forward_ms.train", ctx) + read("backward_ms.train", ctx) \
        + read("optimizer_ms.train", ctx)
    assert phases <= t.busy_s * 1e3 / 2


@pytest.mark.parametrize("metric", [
    "plan_idle_ms.serve", "images_idle_ms.serve", "view_idle_ms.serve",
    "bev_idle_ms.serve", "launches.serve", "forward_ms.train",
    "backward_ms.train", "forward_idle_ms.train", "backward_idle_ms.train",
    "launches.train"])
def test_none_without_a_trace_a_count_or_the_spans(metric):
    per = "frames" if metric.endswith(".serve") else "steps"
    assert read(metric, {"trace": None, per: 3}) is None
    full = serve_trace() if per == "frames" else train_trace()
    assert read(metric, {"trace": full, per: 0}) is None
    # a program that opens no span of its own: the harness's ranges only
    bare = fake_trace([("conv", 100, 200, 50)], [("ssc.infer", 0, 900),
                                                 ("ssc.step", 0, 900)])
    assert read(metric, {"trace": bare, per: 3}) is None


def test_every_per_layer_metric_has_its_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"] for w in bench["workloads"]}
    for metric in bench["per_layer"]:
        path = os.path.join(BENCH_DIR, "layer_metrics",
                            metric["name"] + ".py")
        assert os.path.isfile(path), metric["name"]
        assert callable(CELL.reader(metric["name"]))
        if metric["source"] == "program_span":
            assert set(metric["workloads"]) <= cells, metric["name"]
