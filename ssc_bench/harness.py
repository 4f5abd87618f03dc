"""What the serving and training cells share: the program under test built
from a configuration file by its family, the seeded weights handed to it,
the modules that may not be loaded, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
from typing import Dict, List, Optional

import torch

from . import families, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "stereoscene_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one that may not run here."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def weight_spec(config: Dict) -> weights.Spec:
    """The (name, shape) of every tensor of the model's ``state_dict``,
    read off the family's reference built on the meta device."""
    return weights.spec_of(families.of(config).build_reference(
        config["model"], "meta").state_dict())


def seeded_weights(config: Dict, seed: int, device,
                   spec: Optional[weights.Spec] = None):
    """The seed's weights of ``config``'s model (``spec``: its
    ``weight_spec`` where the caller has it), damped as its family says."""
    return weights.make(spec or weight_spec(config), seed, device,
                        families.of(config).DAMPED)


def load_weights(module: torch.nn.Module, state: Dict[str, torch.Tensor]):
    """Load ``state`` into ``module``; raise on any tensor either side
    lacks (BatchNorm's step counters aside)."""
    result = module.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]}, "
                       f"unexpected {result.unexpected_keys[:5]}")


def build_program(config: Dict, device):
    """The program under test for ``config`` on ``device`` (float32), as
    its family builds it."""
    return families.of(config).build_program(config, device)


def program_build_seconds() -> float:
    """Seconds this process spent compiling the program's kernels (0 when
    the library was already built in this checkout)."""
    from stereoscene_torch import _build

    if torch.cuda.is_available():
        _build.load_kernels()
    return float(_build.build_seconds)


def free() -> None:
    """Return what the deleted program held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_precision() -> None:
    """float32 everywhere: TF32 off for matrix products and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select(cell, trace: bool, end_to_end: Dict[str, float],
           ctx: Dict) -> Dict[str, float]:
    """The metrics a run reports: untraced, the cell's end-to-end
    metrics; traced, its per-layer metrics, each from its reader (a reader
    that finds nothing to read leaves its metric out)."""
    if not trace:
        wanted = {m["name"] for m in cell.end_to_end}
        return {k: v for k, v in end_to_end.items() if k in wanted}
    out = {}
    for metric in cell.per_layer:
        value = cell.reader(metric["name"])(ctx)
        if value is not None:
            out[metric["name"]] = value
    return out


@dataclasses.dataclass
class Outcome:
    """What a cell's run hands back to ``run.py``."""

    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int
    trace: Optional[object] = None
    extra: Dict = dataclasses.field(default_factory=dict)


def result_line(outcome: Outcome, units: Dict[str, str], chips: int,
                device_kind: str, trace_on: bool) -> str:
    device = {"platform": "gpu", "kind": device_kind, "count": chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": bool(outcome.correct),
            "attempted": int(outcome.attempted),
            "failed": int(outcome.failed),
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in outcome.metrics.items()},
            "device": device}
    if trace_on and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                             "idle_gaps": outcome.trace.idle_gaps()}
    line.update(outcome.extra)
    line["checks"] = outcome.checks
    return json.dumps(line)
