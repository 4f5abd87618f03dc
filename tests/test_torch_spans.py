"""The port's own spans (``stereoscene_torch.utils.spans``) on the CPU at
the tiny configuration:

- under a profiler, one ``infer`` records each serving span once, nested
  as ``SPANS`` lists them, with ``stereoscene.plan.build`` only on a
  plan-cache miss;
- a bf16-policy train step records its forward, backward and optimizer
  spans once each, in that order, and ``run_training``'s trace carries a
  ``stereoscene.load`` span for every traced step;
- with no profiler active an ``infer`` enters no ``record_function``,
  and its class map is bitwise the one it gives under the profiler;
- with a stand-in for the image backbone's CUDA graphs, an ``infer``
  opens ``stereoscene.images.capture`` the one time the backbone
  captures and ``stereoscene.images.replay`` each time it replays, both
  inside ``stereoscene.images``;
- every name the package opens is in ``SPANS`` and none is one of the
  benchmark harness's ``ssc.*`` names.
"""

import dataclasses
import json
import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereoscene_torch.config import Config
from stereoscene_torch.engine.loop import run_training, step_generator
from stereoscene_torch.engine.train import (LossConfig, create_train_state,
                                            make_train_step)
from stereoscene_torch.models import efficientnet
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.ops.splat_plan import SplatPlanCache
from stereoscene_torch.tools import _frames
from stereoscene_torch.utils.spans import SPANS
from stereoscene_torch.utils.weights import seeded_init_
from tests.test_torch_backbone_graph import StandInGraphs
from tests.test_torch_loop import _loader, _state, _train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = DetectorConfig.from_config(Config.fromfile(
    str(ROOT / "stereoscene_torch" / "configs" / "stereoscene_tiny.py")))
# 8 Z planes: oneDNN's bf16 Conv3d on the CPU misreads a stride-2 input of
# depth 1 or 2 (tests/test_torch_bench_tools.py)
TINY_Z8 = dataclasses.replace(TINY, zbound=(-2.0, 6.0, 1.0))
LABEL_SHAPE = (16, 16, 8)

# each serving span under its parent
SERVING = {
    "stereoscene.infer": None,
    "stereoscene.plan": "stereoscene.infer",
    "stereoscene.plan.build": "stereoscene.plan",
    "stereoscene.images": "stereoscene.infer",
    "stereoscene.view": "stereoscene.infer",
    "stereoscene.view.stereo": "stereoscene.view",
    "stereoscene.view.depth": "stereoscene.view",
    "stereoscene.view.mie": "stereoscene.view",
    "stereoscene.view.splat": "stereoscene.view",
    "stereoscene.bev": "stereoscene.infer",
    "stereoscene.classmap": "stereoscene.infer",
}
PHASES = ("stereoscene.forward", "stereoscene.backward",
          "stereoscene.optimizer")


def ranges(prof):
    """(name, start ns, end ns) of the profile's ``stereoscene.*`` ranges,
    in the order they opened."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()
                   and e.name().startswith("stereoscene.")),
                  key=lambda r: r[1])


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, ranges(prof)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = BEVDepthOccupancy(TINY, device="cpu", label_shape=LABEL_SHAPE)
    seeded_init_(m, 0)
    return m


@pytest.fixture(scope="module")
def frame():
    return _frames.frame(TINY, "cpu", seed=1)


def test_serving_spans_once_a_frame_nested(model, frame):
    model.plan_cache = SplatPlanCache(model)
    for miss in (True, False):
        _, got = traced(lambda: model.infer(frame))
        names = [n for n, _, _ in got]
        want = [n for n in SERVING if miss or n != "stereoscene.plan.build"]
        assert sorted(names) == sorted(want)
        assert names[0] == "stereoscene.infer"
        by = {n: (s, e) for n, s, e in got}
        for name, parent in SERVING.items():
            if name in by and parent is not None:
                assert by[parent][0] <= by[name][0] <= by[name][1] \
                    <= by[parent][1], name
        # siblings open one after another, as SERVING lists them
        order = [n for n in names if SERVING[n] == "stereoscene.infer"]
        assert order == [n for n in want
                         if SERVING[n] == "stereoscene.infer"]


def test_no_profiler_no_record_function(model, frame, monkeypatch):
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(name, *args):
        entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    model.infer(frame)  # a plan-cache hit from here on
    assert entered == []
    traced(lambda: model.infer(frame))
    assert sorted(entered) == sorted(n for n in SERVING
                                     if n != "stereoscene.plan.build")


def test_class_map_same_with_profiler_on_and_off(model, frame):
    off = model.infer(frame)
    on, _ = traced(lambda: model.infer(frame))
    assert torch.equal(off, on)


def test_backbone_capture_and_replay_spans(model, frame, monkeypatch):
    backend = StandInGraphs()
    monkeypatch.setattr(efficientnet, "GRAPHS", backend)
    want = model.infer(frame)  # eager: the backbone's first call
    inner = ("stereoscene.images.capture", "stereoscene.images.replay")
    for expect in (list(inner), ["stereoscene.images.replay"]):
        got, spans = traced(lambda: model.infer(frame))
        assert torch.equal(got, want)
        assert [n for n, _, _ in spans if n in inner] == expect
        images = [(s, e) for n, s, e in spans if n == "stereoscene.images"]
        assert len(images) == 1
        for n, s, e in spans:
            if n in inner:
                assert images[0][0] <= s <= e <= images[0][1], n
    assert backend.calls == ["capture", "replay", "replay"]
    model.float()  # drops the stand-in's graph


def test_bf16_train_step_phase_spans():
    torch.manual_seed(0)
    model = BEVDepthOccupancy(TINY_Z8, device="cpu")
    seeded_init_(model, 0)
    state = create_train_state(model, device="cpu")
    step = make_train_step(LossConfig(downsample=TINY_Z8.downsample,
                                      dbound=TINY_Z8.dbound), bf16=True)
    batch = _frames.train_frame(TINY_Z8, "cpu", 0, 1)
    _, got = traced(lambda: step(state, batch, step_generator(0, 0, "cpu")))
    phases = [(n, s, e) for n, s, e in got if n in PHASES]
    assert [n for n, _, _ in phases] == list(PHASES)
    for (_, _, end), (_, start, _) in zip(phases, phases[1:]):
        assert end <= start
    # the forward runs the model's stages inside its span
    fs, fe = phases[0][1:]
    inside = {n for n, s, e in got if fs <= s and e <= fe}
    assert {"stereoscene.images", "stereoscene.view",
            "stereoscene.bev"} <= inside
    # the model left its fp32 masters in place
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_run_training_trace_has_a_load_span_a_step(tmp_path):
    run_training(None, _state(), _train_step, _loader(), max_epochs=1,
                 work_dir=str(tmp_path / "work"), log_interval=100,
                 trace_dir=str(tmp_path / "trace"), trace_steps=(2, 5))
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    loads = [e for e in events if e.get("name") == "stereoscene.load"
             and e.get("ph") == "X"]
    assert len(loads) == 3


def test_every_opened_span_is_listed():
    opened = set()
    for path in (ROOT / "stereoscene_torch").rglob("*.py"):
        opened |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert opened == set(SPANS)
    assert len(SPANS) == len(set(SPANS))
    assert all(n.startswith("stereoscene.") for n in SPANS)
    assert not any(n.startswith("ssc.") for n in SPANS)
