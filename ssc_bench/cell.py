"""A cell as the benchmark defines it: ``BENCHMARK.json``'s entry for the
workload, its configuration file, its model family, its traffic file and
the readers of its per-layer metrics, each found by name.

- configuration ``<name>``: the file its ``configs`` entry names;
- model family ``<family>``: ``ssc_bench/families/<family>.py``, named by
  the configuration's ``"family"`` key (``stereoscene`` where it has
  none);
- traffic ``<name>``: ``ssc_bench/traffic/<name>.json``;
- the limits of ``correct``: ``ssc_bench/limits/<workload>.json``, each
  number the cell's comparison reads that decides it, with its limit;
- per-layer metric ``<name>``: ``ssc_bench/layer_metrics/<name>.py``, a
  module with ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List

from . import families

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]

    @property
    def family(self) -> ModuleType:
        return families.of(self.config)

    def reader(self, metric: str) -> Callable:
        path = os.path.join(HERE, "layer_metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "ssc_bench.layer_metrics." + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        limits = json.load(f)
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=limits)
