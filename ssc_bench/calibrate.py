"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 ssc_bench/calibrate.py --workload NAME --seeds A,B,... \\
        [--control A,B,...] [--fault A,B,...] [--seconds S]

For each ``--seeds`` seed: one run of the cell's timed path through
``serve.run`` / ``training.run`` with a short window, its numbers read with
no limit. For each ``--control`` seed: the reference in the program's
place, computed in float8 (e4m3, per-tensor scales: the precision below
the configuration's bfloat16), against the float32 reference, on what the
cell's run would compare. For each ``--fault`` seed: the run with its
timed path broken (serving: every answer's class shifted by one where it
is produced; training: half of each batch left out, the mean taken over
the rest). One JSON line per reading.
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

    from ssc_bench import check, generate, harness, weights
    from ssc_bench.reference import model as reference

    cfg, traffic = cell.config, cell.traffic
    m = cfg["model"]
    harness.reference_precision()
    spec = harness.weight_spec(m)
    state = weights.make(spec, seed, device)
    ref = reference.build(m, device)
    low = reference.build(m, device, quantizer=reference.fp8_quantizer)
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
            classes = reference.upsample(got["logits"], cfg["label_shape"]) \
                .argmax(1)
        gaps = check.serve_frame(got, want, classes, cfg["label_shape"])
        worst = {k: max(worst.get(k, 0.0), v) for k, v in gaps.items()}
    return worst


def _train_control(cell, seed, device):
    import torch

    from ssc_bench import check, generate, harness, weights
    from ssc_bench.reference import model as reference
    from ssc_bench.reference.train import train_steps

    cfg, traffic = cell.config, cell.traffic
    m = cfg["model"]
    harness.reference_precision()
    spec = harness.weight_spec(m)
    batches = generate.train_batches(traffic, m["input_size"],
                                     tuple(cfg["label_shape"]), m["dbound"],
                                     seed, device)
    n = traffic["check_steps"]
    runs = []
    for quantizer in (None, reference.fp8_quantizer):
        net = reference.build(m, device, quantizer=quantizer,
                              checkpoint_blocks=torch.device(device).type
                              == "cuda")
        harness.load_weights(net, weights.make(spec, seed, device))
        grads = {}
        outputs = check.FirstOutputs(net)
        logs = train_steps(
            net, batches[:n], [generate.step_generator(seed, s, device)
                               for s in range(n)],
            cfg["loss_weights"], cfg["optimizer"], m["downsample"],
            m["dbound"], lambda names, gs: grads.update(
                check.leaf_norms(list(zip(names, gs)))))
        runs.append({"losses": [x["loss_total"] for x in logs],
                     "grad_norms": grads, **outputs.remove(),
                     "change_norms": check.change_norms(
                         net.named_parameters(),
                         weights.make(spec, seed, device))})
        del net
        harness.free()
    return check.train_steps(runs[1], runs[0])


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


TRAIN_FAULTS = {"half_batch": _half_batch,
                "half_batch_loss": _half_batch_loss}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fp32-program", action="store_true",
                   help="run the program in float32 (a witness)")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from ssc_bench import cell as cells
    from ssc_bench import serve, training

    cell = cells.load(ROOT, args.workload)
    if args.fp32_program:
        cell.config["precision"] = "float32"
    from ssc_bench import check

    cell.limits = dict.fromkeys(check.SERVE_NUMBERS if cell.traffic["kind"]
                                == "serve" else check.TRAIN_NUMBERS,
                                float("inf"))
    device = torch.device("cuda", 0)
    is_serve = cell.traffic["kind"] == "serve"
    runner = serve if is_serve else training

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(kind, seed, t, **out):
        print(json.dumps({"kind": kind, "seed": seed,
                          "seconds": round(time.time() - t, 2), **out}),
              flush=True)

    for seed in seeds(args.seeds):
        t = time.time()
        o = runner.run(cell, seed, args.seconds, False, device, t)
        emit("program", seed, t, checks={k: c["value"] for k, c in
                                         o.checks.items()},
             metrics=o.metrics, attempted=o.attempted,
             peak_gib=o.memory_peak_bytes / 2 ** 30)
    for seed in seeds(args.control):
        t = time.time()
        emit("control", seed, t, checks=(_serve_control if is_serve
                                         else _train_control)(cell, seed,
                                                              device))
    classes = cell.config["model"]["out_channel"]
    faults = ({"class_shift": {"break_answer": lambda c: (c + 1) % classes}}
              if is_serve else {name: {"break_step": f} for name, f in
                                TRAIN_FAULTS.items()})
    for seed in seeds(args.fault):
        for name, kw in faults.items():
            t = time.time()
            o = runner.run(cell, seed, args.seconds, False, device, t, **kw)
            emit("fault", seed, t, fault=name,
                 checks={k: c["value"] for k, c in o.checks.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
