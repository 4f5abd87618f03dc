"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 ssc_bench/calibrate.py --workload NAME --seeds A,B,... \\
        [--control A,B,...] [--fault A,B,...] [--seconds S] \\
        [--outputs NAME=MODULE,...] [--fp32-program] [--witness A,B,...]

For each ``--seeds`` seed: one run of the cell's timed path through
``serve.run`` / ``training.run`` with a short window, its numbers read with
no limit. For each ``--control`` seed: the reference in the program's
place, computed in float8 (e4m3, per-tensor scales: the precision below
the configuration's bfloat16), against the float32 reference, on what the
cell's run would compare. For each ``--fault`` seed: the run with its
timed path broken (serving: every answer's class shifted by one where it
is produced; training: each of ``TRAIN_FAULTS``). ``--outputs`` compares
the first training step's outputs of further modules as well (a witness
of where a gap grows). For each ``--witness`` seed (training): the
control's comparison with the reference's products in bfloat16 instead,
what the configuration's rounding alone reads. One JSON line per reading; a program's line gives
``peak_gib``, the program's peak, and ``after_peak_gib``, the process's
peak over its window and its reference.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_control(cell, seed, device):
    import torch

    from ssc_bench import generate, harness
    from ssc_bench.reference.precision import fp8_quantizer

    cfg, traffic, family = cell.config, cell.traffic, cell.family
    m = cfg["model"]
    harness.reference_precision()
    state = harness.seeded_weights(cfg, seed, device)
    ref = family.build_reference(m, device)
    low = family.build_reference(m, device, quantizer=fp8_quantizer)
    harness.load_weights(ref, state)
    harness.load_weights(low, state)
    del state
    pool = generate.frame_pool(traffic, m["input_size"], seed, device)
    slots = random.Random(seed).sample(range(traffic["pool"]),
                                       traffic["check_frames"])
    worst = {}
    for slot in slots:
        geo = generate.geometry_batch(traffic, m["input_size"],
                                      traffic["batch"], slot, device)
        batch = dict(geo, imgs=pool[slot].to(device))
        with torch.no_grad():
            want, got = ref(batch), low(batch)
            classes = family.classes_of(got, cfg["label_shape"])
        gaps = family.serve_frame(got, want, classes, cfg["label_shape"])
        worst = {k: max(worst.get(k, 0.0), v) for k, v in gaps.items()}
    return worst


def _train_control(cell, seed, device, quantizer=None):
    from ssc_bench import check, harness
    from ssc_bench.reference.precision import fp8_quantizer
    from ssc_bench.training import reference_steps

    staged = hasattr(cell.family, "FirstStage")
    got = reference_steps(cell.config, cell.traffic, seed, device,
                          quantizer=quantizer or fp8_quantizer,
                          keep_first=staged)
    harness.free()
    want = reference_steps(cell.config, cell.traffic, seed, device,
                           first=got.get("first"))
    harness.free()
    return dict(check.train_steps(got, want, cell.family.FIRST_OUTPUTS),
                **want["stage"])


def _half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(state, batch, generator=None):
        b = batch["imgs"].shape[0] // 2
        return step(state, {k: v[:b] for k, v in batch.items()}, generator)
    return broken


def _half_batch_loss(step):
    """The forward over the whole batch, the loss over its first half: the
    other half's labels all ignore and its depth all missing."""
    def broken(state, batch, generator=None):
        b = batch["imgs"].shape[0] // 2
        occ, depth = batch["gt_occ"].clone(), batch["gt_depth"].clone()
        occ[b:], depth[b:] = 255, 0
        return step(state, dict(batch, gt_occ=occ, gt_depth=depth),
                    generator)
    return broken


def _loss_slab(step):
    """The loss over all but a sixteenth of the label grid (the labels of
    its first sixteenth of Y all ignore), as a streaming loss of 16 slabs
    that leaves one out."""
    def broken(state, batch, generator=None):
        occ = batch["gt_occ"].clone()
        occ[:, :, :max(1, occ.shape[2] // 16)] = 255
        return step(state, dict(batch, gt_occ=occ), generator)
    return broken


TRAIN_FAULTS = {"half_batch": _half_batch,
                "half_batch_loss": _half_batch_loss,
                "loss_slab": _loss_slab}
HALVES = ("half_batch", "half_batch_loss")  # need two frames or more


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--witness", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fp32-program", action="store_true",
                   help="run the program in float32 (a witness)")
    p.add_argument("--outputs", default="",
                   help="NAME=MODULE,... first training outputs to compare")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from ssc_bench import cell as cells
    from ssc_bench import serve, training

    cell = cells.load(ROOT, args.workload)
    if args.fp32_program:
        cell.config["precision"] = "float32"
    from ssc_bench import check

    if args.outputs:
        cell.family.FIRST_OUTPUTS = dict(
            cell.family.FIRST_OUTPUTS,
            **dict(kv.split("=", 1) for kv in args.outputs.split(",")))
    is_serve = cell.traffic["kind"] == "serve"
    cell.limits = dict.fromkeys(cell.family.SERVE_NUMBERS if is_serve
                                else check.train_numbers(cell.family),
                                float("inf"))
    device = torch.device("cuda", 0)
    runner = serve if is_serve else training

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(kind, seed, t, **out):
        print(json.dumps({"kind": kind, "seed": seed,
                          "seconds": round(time.time() - t, 2), **out}),
              flush=True)

    for seed in seeds(args.seeds):
        t = time.time()
        torch.cuda.reset_peak_memory_stats()
        o = runner.run(cell, seed, args.seconds, False, device, t)
        emit("program", seed, t, checks={k: c["value"] for k, c in
                                         o.checks.items()},
             metrics=o.metrics, attempted=o.attempted,
             peak_gib=o.memory_peak_bytes / 2 ** 30,
             after_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for seed in seeds(args.control):
        t = time.time()
        emit("control", seed, t, checks=(_serve_control if is_serve
                                         else _train_control)(cell, seed,
                                                              device))
    for seed in seeds(args.witness):
        from ssc_bench.reference.precision import bf16_quantizer

        t = time.time()
        emit("witness", seed, t, checks=_train_control(
            cell, seed, device, quantizer=bf16_quantizer))
    classes = cell.family.num_classes(cell.config)
    faults = ({"class_shift": {"break_answer": lambda c: (c + 1) % classes}}
              if is_serve else {name: {"break_step": f} for name, f in
                                TRAIN_FAULTS.items()
                                if cell.traffic["batch"] > 1
                                or name not in HALVES})
    for seed in seeds(args.fault):
        for name, kw in faults.items():
            t = time.time()
            o = runner.run(cell, seed, args.seconds, False, device, t, **kw)
            emit("fault", seed, t, fault=name,
                 checks={k: c["value"] for k, c in o.checks.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
