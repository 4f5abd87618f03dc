"""The harness's arithmetic on hand-made inputs: the tail, the rate, the
idle share and the busy union of a trace, the roofline share, the bounds
against the program's earlier chip checks, and the FLOP count."""

import json
import os
import statistics

import pytest

from ssc_bench import check, flops, roofline, serve
from ssc_bench.cell import Cell
from ssc_bench.families import stereoscene
from ssc_bench.trace import Op, Trace

from .conftest import ROOT

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_p95_is_the_exclusive_quantile():
    values = [float(v) for v in range(1, 101)]
    assert serve.p95(values) == pytest.approx(95.95)
    assert serve.p95(values) == statistics.quantiles(values, n=20)[-1]
    assert serve.p95([7.0]) == 7.0  # a window of one frame


def fake_trace(ops, ranges, window=(0, 1000)):
    t = Trace.__new__(Trace)
    t.ops = [Op(*o) for o in ops]
    t.ranges = list(ranges) + [("ssc.window", *window)]
    t.window = window
    return t


def test_busy_union_idle_share_and_gaps():
    # two overlapping ops and one apart: busy 300 + 100 of a 1,000 ns window
    t = fake_trace([("a", 100, 300, 90), ("b", 200, 400, 95),
                    ("c", 600, 700, 550)],
                   [("ssc.infer", 0, 500), ("ssc.classmap_d2h", 500, 900)])
    assert t.busy_s == pytest.approx(400e-9)
    ctx = {"trace": t}
    share = Cell.reader(Cell("x", 1, {}, {}, [], [], {}),
                        "idle_share.serve")(ctx)
    assert share == pytest.approx(60.0)
    # gaps [0, 100), [400, 600), [700, 1000), by the range at each midpoint
    # (the shorter where two meet)
    assert dict(t.idle_gaps()) == {"ssc.infer": pytest.approx(100e-9),
                                   "ssc.classmap_d2h": pytest.approx(500e-9)}


def test_seconds_under_a_range_and_by_name():
    t = fake_trace([("adam", 100, 150, 10), ("adam", 200, 260, 40),
                    ("conv", 300, 400, 60)],
                   [("Optimizer.step#AdamW.step", 0, 50)])
    assert t.seconds_under("Optimizer.step#AdamW.step") == \
        pytest.approx(110e-9)
    assert t.device_seconds("adam") == (pytest.approx(110e-9), 2)


def test_roofline_share_of_hand_made_launches(monkeypatch):
    """Two K3 calls at twice their bound each read 50%."""
    import torch

    with open(os.path.join(ROOT, "ssc_bench/configs/"
                           "stereoscene_kitti.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "ssc_bench/traffic/camera_stream.json")) as f:
        traffic = json.load(f)
    m = config["model"]
    plan = roofline.splat_plan(m, traffic, 8)
    work = roofline.k3(7680, 112, 128, plan["num_voxels"], plan["padded"],
                       plan["live"], 2)
    bound = roofline.bound_s(work["bytes"], work["ops"], H100, work["rate"])
    ns = int(round(2 * bound * 1e9))
    t = fake_trace([("splat_chunks<bf16>", 0, ns - 1000, 0),
                    ("splat_fixup", ns - 1000, ns, 0),
                    ("splat_chunks<bf16>", ns, 2 * ns - 1000, 0),
                    ("splat_fixup", 2 * ns - 1000, 2 * ns, 0)], [],
                   window=(0, 2 * ns))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda _d=None: "NVIDIA H100 80GB HBM3")
    cell = Cell("kitti-serve-stream", 1, config, traffic, [], [], {})
    share = cell.reader("K3_roofline")({"trace": t, "cell": cell,
                                        "device": None})
    assert share == pytest.approx(50.0, rel=1e-5)  # whole ns


def test_bounds_match_the_program_chip_checks():
    """PERF.md's kernel table: K3 on the highres plan 0.3278 ms (fp32
    tables, 2,181,120 rows), K1 0.0170 ms, P1 0.0295 ms."""
    k3 = roofline.k3(7680, 112, 128, 2097152, 2181120, 0, 4)
    k1 = roofline.k1(7680, 64, 112, 32, 2, 2)
    p1 = roofline.p1(7680, 640, 9, 2, 4)
    ms = [1e3 * roofline.bound_s(w["bytes"], w["ops"], H100, w["rate"])
          for w in (k3, k1, p1)]
    assert [round(v, 4) for v in ms] == [0.3278, 0.0170, 0.0295]


def test_flops_of_the_published_forward():
    """Phase 10's count of the fp32 eval forward at 128x128x16: 4,203.43
    GFLOP (convolutions 4,136.42, bmm 67.00)."""
    with open(os.path.join(ROOT, "ssc_bench/configs/"
                           "stereoscene_kitti.json")) as f:
        config = json.load(f)
    assert flops.forward_flops(config, 1) / 1e9 == \
        pytest.approx(4203.43, abs=0.01)


def test_leaf_gap_measure():
    want = {"a": 1.0, "b": 0.001, "c": 2.0}
    got = {"a": 1.1, "b": 0.0, "c": 2.0}
    # b is measured against the median leaf (1.0), not its own norm
    assert check.leaf_gap(got, want) == pytest.approx(0.1)
    import torch

    one = torch.ones(2, 3)
    prog = {"losses": [1.0, 2.0], "grad_norms": got, "change_norms": got,
            "stage2": one * 1.1, "logit1": one[:1]}
    ref = {"losses": [1.0, 2.2], "grad_norms": want, "change_norms": want,
           "stage2": one, "logit1": one}
    gaps = check.train_steps(prog, ref, ("stage2", "logit1"))
    assert gaps["loss_gap"] == pytest.approx(0.2 / 2.2)
    assert gaps["change_gap"] == pytest.approx(0.1)
    # the 98th percentile of the kept leaves' change gaps (a 0.1, b 0.001)
    assert gaps["change_p98"] == pytest.approx(
        check.p98([0.1, 0.001, 0.0]))
    assert gaps["stage2_gap"] == pytest.approx(0.1)
    assert gaps["logit1_gap"] == float("inf")  # another shape


def test_first_outputs_keep_without_changing():
    """The hooks keep a float copy of the first output and hand the
    module's own output on (a bf16 model stays bf16)."""
    import torch

    net = torch.nn.Module()
    net.img_backbone = torch.nn.Module()
    net.img_backbone.layers = torch.nn.ModuleList(
        [torch.nn.Identity(), torch.nn.Identity(),
         torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 2))])
    net.pts_bbox_head = torch.nn.Linear(2, 2)
    net.to(torch.bfloat16)
    keep = check.FirstOutputs(net, stereoscene.FIRST_OUTPUTS)
    x = torch.ones(1, 2, dtype=torch.bfloat16)
    first = net.pts_bbox_head(net.img_backbone.layers[2](x))
    net.pts_bbox_head(x * 2)
    out = keep.remove()
    assert first.dtype == torch.bfloat16
    assert out["logit1"].dtype == torch.float32
    assert torch.equal(out["logit1"], first.float())
    assert set(out) == {"stage2", "logit1"}
