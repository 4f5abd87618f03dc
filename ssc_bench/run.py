"""Run one cell of the benchmark once and print its result line.

    python3 ssc_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout (``BENCHMARK.json`` beside it) on a
machine with the cards the cell asks for. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device`` and, traced, ``breakdown``; then
``build_s`` (this process's kernel compile, 0 once built) and, last,
``checks``: every number that decided ``correct`` beside its limit, which
also end standard error.

Exits 2 without a result where CUDA is missing or the cell asks for more
cards than there are, and 3 where a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from ssc_bench import cell as cells
    from ssc_bench import harness, serve, training

    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s), found "
              f"{count}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    runner = serve if cell.traffic["kind"] == "serve" else training
    outcome = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    line = harness.result_line(outcome, units, cell.chips,
                               torch.cuda.get_device_name(0),
                               bool(args.trace))
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
