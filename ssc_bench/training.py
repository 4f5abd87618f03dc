"""A training cell: the program's own step (``engine.train``'s
``create_train_state`` and ``make_train_step`` in the bf16 policy) over
seeded batches made on the device.

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
batches and dropout draws.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
from torch.profiler import record_function

from . import check, generate, harness, weights
from .cell import Cell
from .reference import model as reference
from .reference.train import train_steps
from .trace import WINDOW, Trace


def loss_config(cfg: Dict):
    from stereoscene_torch.engine.train import LossConfig

    w, m = cfg["loss_weights"], cfg["model"]
    return LossConfig(voxel_ce=w["voxel_ce"],
                      voxel_sem_scal=w["voxel_sem_scal"],
                      voxel_geo_scal=w["voxel_geo_scal"],
                      loss_depth_weight=w["depth"], loss_depth_type="bce",
                      stream_voxel_chunks=w.get("stream_voxel_chunks", 0),
                      downsample=m["downsample"], dbound=tuple(m["dbound"]))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, break_step=None) -> harness.Outcome:
    """``break_step(step)`` (tests only) wraps the program's step."""
    from stereoscene_torch.engine.train import (create_train_state,
                                                make_train_step)

    cfg, traffic = cell.config, cell.traffic
    m, opt = cfg["model"], cfg["optimizer"]
    cuda = torch.device(device).type == "cuda"
    label_shape = tuple(cfg["label_shape"])
    build_s = harness.program_build_seconds() if cuda else 0.0
    spec = harness.weight_spec(m)
    model = harness.build_program(cfg, device)
    harness.load_weights(model, weights.make(spec, seed, device))
    state = create_train_state(model, lr=opt["lr"],
                               weight_decay=opt["weight_decay"],
                               grad_clip=opt["grad_clip"], device=device)
    step = make_train_step(loss_config(cfg), bf16=cfg["precision"]
                           == "bfloat16")
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
    outputs = check.FirstOutputs(model)
    for s in range(first):
        logs = one(s)
        outputs.remove()
        losses.append(float(logs["loss_total"]))
        if s == 0:
            moments = [(n, state.optimizer.state[p]["exp_avg"])
                       for n, p in state.trainable]
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            grad_norms = check.leaf_norms(moments, 1 / (1 - beta1))
    prog = {"losses": losses, **outputs.out, "grad_norms": grad_norms,
            "change_norms": check.change_norms(
                state.trainable, weights.make(spec, seed, device))}
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
    checks = check.judge(check.train_steps(prog, _reference(cfg, traffic,
                                                            seed, device)),
                         cell.limits)
    return harness.Outcome(
        correct=check.passed(checks), attempted=steps, failed=0,
        metrics=harness.select(cell, trace, metrics, ctx), checks=checks,
        memory_peak_bytes=peak, trace=tracer, extra={"build_s": build_s})


def _reference(cfg, traffic, seed, device) -> Dict:
    """The reference's first steps: losses, first clipped gradient's leaf
    norms, leaf changes."""
    harness.reference_precision()
    m = cfg["model"]
    ref = reference.build(m, device, checkpoint_blocks=torch.device(
        device).type == "cuda")
    spec = harness.weight_spec(m)
    harness.load_weights(ref, weights.make(spec, seed, device))
    batches = generate.train_batches(traffic, m["input_size"],
                                     tuple(cfg["label_shape"]), m["dbound"],
                                     seed, device)
    n = traffic["check_steps"]
    grads = {}
    outputs = check.FirstOutputs(ref)
    logs = train_steps(
        ref, batches[:n], [generate.step_generator(seed, s, device)
                           for s in range(n)],
        cfg["loss_weights"], cfg["optimizer"], m["downsample"], m["dbound"],
        lambda names, gs: grads.update(check.leaf_norms(list(zip(names,
                                                                 gs)))))
    return {"losses": [x["loss_total"] for x in logs], "grad_norms": grads,
            **outputs.remove(),
            "change_norms": check.change_norms(
                ref.named_parameters(), weights.make(spec, seed, device))}
