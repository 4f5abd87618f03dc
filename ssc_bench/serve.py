"""A serving cell: the program's serving call (``model.infer(batch)``;
StereoScene: ``BEVDepthOccupancy.infer``) answering a camera stream in a
closed loop, one frame in flight.

The client takes the newest frame as soon as the last answer is out, as a
driving stack does with a camera faster than its model: each frame is
handed over as a pinned host tensor, answered, and its class map copied
back into a pinned host buffer that the client reuses; its time runs from
the hand-over to that copy's end. The window closes with the first answer
out after ``seconds``; ``frames_per_s`` is the frames answered over the
window's length.

Set-up builds the program in the configuration's precision from the
seed's weights, draws the frame pool and warms up on the cell's own
frames, which builds the one calibration's splat plan, so every timed
frame hits the plan cache. Once the window has closed, the last answer of
each of ``check_frames`` pool slots drawn from the seed is held against
the plain reference (float32, TF32 off) on the same frame.
"""

from __future__ import annotations

import contextlib
import random
import statistics
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from . import check, families, generate, harness
from .cell import Cell
from .trace import WINDOW, Trace


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method;
    a window of one frame reads that frame)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]


class Capture:
    """Forward hooks that keep, for the pool slots under check, the last
    outputs of the timed path that the family's comparison reads
    (``SERVE_OUTPUTS``), and (traced runs) CUDA events at its stage
    boundaries (``STAGES``)."""

    def __init__(self, model, family, slots, spans: bool):
        self.slots, self.slot = set(slots), None
        self.out: Dict[int, Dict[str, torch.Tensor]] = {}
        self.marks: Dict[str, torch.cuda.Event] = {}
        self.stage_names = [name for name, _ in family.STAGES]
        self.stages: List[tuple] = []
        self.handles = [
            model.get_submodule(path).register_forward_hook(
                self._keeper(key, keep))
            for key, (path, keep) in family.SERVE_OUTPUTS.items()]
        if spans:
            for name, path in family.STAGES:
                self.handles.append(model.get_submodule(path)
                                    .register_forward_pre_hook(
                                        self._mark(name)))

    def _mark(self, name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[name] = ev
        return hook

    def _keeper(self, key, keep):
        def hook(_m, _i, out):
            if self.slot in self.slots:
                self.out.setdefault(self.slot, {})[key] = keep(out)
        return hook

    def frame_done(self) -> None:
        if self.marks:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.stages.append(tuple(self.marks[name]
                                     for name in self.stage_names) + (end,))

    def stage_ms(self) -> Dict[str, List[float]]:
        """Each stage's device ms a frame, from its module's pre-hook to
        the next stage's (the last: to the class map)."""
        torch.cuda.synchronize()
        out = {name: [] for name in self.stage_names}
        for events in self.stages:
            for name, a, b in zip(self.stage_names, events, events[1:]):
                out[name].append(a.elapsed_time(b))
        return out

    def remove(self):
        for h in self.handles:
            h.remove()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, break_answer=None) -> harness.Outcome:
    """``break_answer(classes)`` (tests only) alters each answer where it
    is produced."""
    cfg, traffic, family = cell.config, cell.traffic, cell.family
    m = cfg["model"]
    cuda = torch.device(device).type == "cuda"
    dtype = getattr(torch, cfg["precision"])

    build_s = harness.program_build_seconds() if cuda else 0.0
    model = harness.build_program(cfg, device)
    harness.load_weights(model, harness.seeded_weights(cfg, seed, device))
    model.to(dtype)
    pool = generate.frame_pool(traffic, m["input_size"], seed, device)
    geos = [generate.geometry_batch(traffic, m["input_size"],
                                    traffic["batch"], i, device)
            for i in range(generate.calibration_period(traffic))]
    slots = random.Random(seed).sample(range(traffic["pool"]),
                                       traffic["check_frames"])
    capture = Capture(model, family, slots, spans=trace and cuda)

    received: Dict[int, torch.Tensor] = {}

    def answer(i: int) -> torch.Tensor:
        slot = i % len(pool)
        capture.slot = slot
        with record_function("ssc.frame_h2d"):
            batch = dict(geos[i % len(geos)],
                         imgs=pool[slot].to(device, non_blocking=True))
        with record_function("ssc.infer"):
            classes = model.infer(batch)
        if break_answer is not None:
            classes = break_answer(classes)
        capture.frame_done()
        with record_function("ssc.classmap_d2h"):
            buf = received.get(slot if slot in capture.slots else -1)
            return classes.cpu() if buf is None else buf.copy_(classes)

    answers: Dict[int, tuple] = {}
    for i in range(traffic["warmup_frames"]):
        shape = answer(i).shape
    # the receiving side's buffers, pinned and reused as a camera client's
    # would be: one for each slot under check, one for the others
    for slot in sorted(capture.slots) + [-1]:
        received[slot] = torch.empty(shape, dtype=torch.int64,
                                     pin_memory=cuda)
    capture.stages.clear()
    capture.out.clear()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t0

    latencies: List[float] = []
    tracer = Trace() if trace and cuda else None
    with (tracer or contextlib.nullcontext()):
        with record_function(WINDOW):
            start = time.perf_counter()
            i = 0
            done = start
            while done - start < seconds:
                handed = done
                classes = answer(i)
                done = time.perf_counter()
                latencies.append((done - handed) * 1e3)
                if i % len(pool) in capture.slots:
                    answers[i % len(pool)] = (i, classes)
                i += 1
            window_s = done - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = capture.stage_ms() if capture.stages else {}
    capture.remove()
    outputs = capture.out
    del model, pool, capture
    harness.free()

    frames = len(latencies) * traffic["batch"]
    metrics = {"frames_per_s": frames / window_s,
               "frame_ms_p95": p95(latencies),
               "setup_s": setup_s}
    ctx = {"cell": cell, "frames": frames, "window_s": window_s,
           "trace": tracer, "spans": spans, "device": device}
    checks = _check(cfg, traffic, cell.limits, seed, device, slots, outputs,
                    answers)
    return harness.Outcome(
        correct=check.passed(checks), attempted=len(latencies), failed=0,
        metrics=harness.select(cell, trace, metrics, ctx), checks=checks,
        memory_peak_bytes=peak, trace=tracer, extra={"build_s": build_s})


def _check(cfg, traffic, limits, seed, device, slots, outputs,
           answers) -> Dict:
    """The sampled frames against the reference (float32, TF32 off)."""
    harness.reference_precision()
    m = cfg["model"]
    family = families.of(cfg)
    ref = family.build_reference(m, device)
    harness.load_weights(ref, harness.seeded_weights(cfg, seed, device))
    pool = generate.frame_pool(traffic, m["input_size"], seed, device)
    worst = dict.fromkeys(family.SERVE_NUMBERS, 0.0)
    for slot in slots:
        if slot not in outputs or slot not in answers:
            worst = dict.fromkeys(worst, float("inf"))
            continue
        i, classes = answers[slot]
        geo = generate.geometry_batch(traffic, m["input_size"],
                                      traffic["batch"], i, device)
        with torch.no_grad():
            out = ref(dict(geo, imgs=pool[slot].to(device)))
        for j in range(traffic["batch"]):
            gaps = family.serve_frame(
                {k: v[j:j + 1] for k, v in outputs[slot].items()},
                {k: v[j:j + 1] for k, v in out.items()}, classes[j:j + 1],
                tuple(cfg["label_shape"]))
            worst = {k: max(worst[k], gaps[k]) for k in worst}
        del out
    return check.judge(worst, limits)
