"""FLOP and parameter report, the port's counterpart of
``stereoscene_tpu/engine/flops.py`` (which replaces the reference's fvcore
table printed at eval start, ref: occupancy/apis/test.py:24,84,171).

``torch.utils.flop_counter.FlopCounterMode`` counts the aten ops it has a
formula for: matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``),
convolutions and their transposes, and attention, at 2 FLOPs a
multiply-add. Elementwise work, reductions, gathers and the hand-written
kernels count nothing: the kernels launch through ``_build.launch`` and
never reach aten. So the count runs the plain route (``use_kernel=False``),
and the report line names what it counts. XLA's ``cost_analysis``, which
the JAX package reports, counts elementwise work too: the two packages'
FLOP numbers are not comparable. Bytes are not measured here; the line
prints ``n/a`` where the JAX line prints them.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def param_count(model: torch.nn.Module) -> int:
    """The number of parameter values (the JAX package's ``params`` tree;
    BatchNorm statistics are buffers, not counted)."""
    return sum(p.numel() for p in model.parameters())


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[int, Dict[str, int]]:
    """(total FLOPs, FLOPs by aten op) of one call ``fn(*args, **kwargs)``
    as ``FlopCounterMode`` counts them."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts()["Global"].items()}
    return int(counter.get_total_flops()), by_op


def report(fn: Callable, model: torch.nn.Module, *args,
           name: str = "model", file=None, **kwargs) -> Dict:
    """Count ``fn(*args, **kwargs)`` (run it on the plain route), print one
    ``[flops]`` line in the JAX package's format and return ``{"flops",
    "by_op", "params"}``."""
    flops, by_op = count_flops(fn, *args, **kwargs)
    params = param_count(model)
    ops = ", ".join(f"{op} {n / 1e9:.2f}" for op, n in sorted(
        by_op.items(), key=lambda item: -item[1]))
    print(f"[flops] {name}: {flops / 1e9:.2f} GFLOP/call, n/a GB accessed, "
          f"{params / 1e6:.2f} M params (aten matmul and conv FLOPs of the "
          f"plain route, torch FlopCounterMode, GFLOP by op: {ops}; "
          "elementwise work, the CUDA kernels and bytes not counted)",
          file=file, flush=True)
    return {"flops": flops, "by_op": by_op, "params": params}
