"""A training cell: the program's own step (its family's
``train_program``; StereoScene: ``engine.train``'s ``create_train_state``
and ``make_train_step`` in the bf16 policy) over seeded batches made on
the device.

Set-up builds one train state from the seed's weights and drives it
through its first ``check_steps`` steps, each on its own batch, through
the window's own call and feed; it reads the first step's clipped gradient
off the optimizer's state (AdamW's first moment after one step is a tenth
of it) and each leaf's change after those steps. The window then runs
the same state on, step after step, cycling the batches, and ends on a
synchronise; ``train_frames_per_s`` is the frames of every step over the
window, ``train_peak_gib`` the allocated peak within it.

Once the window has closed and the program is freed, the plain reference
(float32, TF32 off) takes the same first steps from the same weights,
batches and dropout draws. Where the family judges stages of the first
step alone (``FirstStage``, ``stage_gaps``), the reference first runs
each on what the program fed it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
from torch.profiler import record_function

from . import check, families, generate, harness
from .cell import Cell
from .reference.train import train_steps
from .trace import WINDOW, Trace


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, break_step=None) -> harness.Outcome:
    """``break_step(step)`` (tests only) wraps the program's step."""
    cfg, traffic, family = cell.config, cell.traffic, cell.family
    m = cfg["model"]
    cuda = torch.device(device).type == "cuda"
    label_shape = tuple(cfg["label_shape"])
    build_s = harness.program_build_seconds() if cuda else 0.0
    spec = harness.weight_spec(cfg)
    model = harness.build_program(cfg, device)
    harness.load_weights(model, harness.seeded_weights(cfg, seed, device,
                                                       spec))
    state, step = family.train_program(model, cfg, device)
    if break_step is not None:
        step = break_step(step)
    batches = generate.train_batches(traffic, m["input_size"], label_shape,
                                     m["dbound"], seed, device)

    def one(s: int):
        with record_function("ssc.step"):
            return step(state, batches[s % len(batches)],
                        generate.step_generator(seed, s, device))[1]

    first = traffic["check_steps"]
    losses, grad_norms = [], None
    outputs = check.FirstOutputs(model, family.FIRST_OUTPUTS)
    stage = family.FirstStage(model) if hasattr(family, "FirstStage") \
        else None
    for s in range(first):
        logs = one(s)
        outputs.remove()
        kept = stage.remove() if stage is not None else {}
        losses.append(float(logs["loss_total"]))
        if s == 0:
            moments = [(n, state.optimizer.state[p]["exp_avg"])
                       for n, p in state.trainable]
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            grad_norms = check.leaf_norms(moments, 1 / (1 - beta1))
    prog = {"losses": losses, **outputs.out, "grad_norms": grad_norms,
            "change_norms": check.change_norms(
                state.trainable,
                harness.seeded_weights(cfg, seed, device, spec))}
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t0

    tracer = Trace() if trace and cuda else None
    steps = 0
    with (tracer or contextlib.nullcontext()):
        with record_function(WINDOW):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                one(first + steps)
                steps += 1
            with record_function("ssc.sync"):
                if cuda:
                    torch.cuda.synchronize()
            window_s = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(window_peak, setup_peak) if cuda else 0
    del state, step, model, batches
    harness.free()

    b = traffic["batch"]
    metrics = {"train_frames_per_s": steps * b / window_s,
               "train_peak_gib": window_peak / 2 ** 30,
               "setup_s": setup_s}
    ctx = {"cell": cell, "steps": steps, "frames": steps * b,
           "window_s": window_s, "trace": tracer, "spans": {},
           "device": device}
    ref = reference_steps(cfg, traffic, seed, device, first=dict(
        kept, **outputs.out, loss1=losses[0]) if stage is not None else None)
    checks = check.judge(dict(check.train_steps(prog, ref,
                                                family.FIRST_OUTPUTS),
                              **ref["stage"]), cell.limits)
    return harness.Outcome(
        correct=check.passed(checks), attempted=steps, failed=0,
        metrics=harness.select(cell, trace, metrics, ctx), checks=checks,
        memory_peak_bytes=peak, trace=tracer, extra={"build_s": build_s})


def reference_steps(cfg, traffic, seed, device, quantizer=None, first=None,
                    keep_first=False) -> Dict:
    """The reference's first steps (every product through ``quantizer``
    where one is given): losses, the first outputs, the first clipped
    gradient's leaf norms, leaf changes; ``stage``: the family's
    ``stage_gaps`` of ``first`` (what another side's first step fed and
    made), judged before the steps; with ``keep_first``, ``first``: this
    side's own, for the same judgement."""
    harness.reference_precision()
    m = cfg["model"]
    family = families.of(cfg)
    ref = family.build_reference(
        m, device, quantizer=quantizer,
        checkpoint_blocks=torch.device(device).type == "cuda")
    spec = harness.weight_spec(cfg)
    harness.load_weights(ref, harness.seeded_weights(cfg, seed, device,
                                                     spec))
    batches = generate.train_batches(traffic, m["input_size"],
                                     tuple(cfg["label_shape"]), m["dbound"],
                                     seed, device)
    n = traffic["check_steps"]
    stage = {} if first is None else family.stage_gaps(ref, first,
                                                       batches[0], cfg)
    grads = {}
    outputs = check.FirstOutputs(ref, family.FIRST_OUTPUTS)
    kept = family.FirstStage(ref) if keep_first else None
    logs = train_steps(
        ref, batches[:n], [generate.step_generator(seed, s, device)
                           for s in range(n)],
        lambda out, batch: family.reference_losses(out, batch, cfg),
        cfg["optimizer"],
        lambda names, gs: grads.update(check.leaf_norms(list(zip(names,
                                                                 gs)))))
    losses = [x["loss_total"] for x in logs]
    out = {"losses": losses, "grad_norms": grads, "stage": stage,
           **outputs.remove()}
    if kept is not None:
        out["first"] = dict(kept.remove(), **{k: out[k] for k in
                                              family.FIRST_OUTPUTS},
                            loss1=losses[0])
    return {**out,
            "change_norms": check.change_norms(
                ref.named_parameters(),
                harness.seeded_weights(cfg, seed, device, spec))}
